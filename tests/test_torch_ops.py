"""ray_tpu_torch.ops against ray_tpu.ops on the CPU.

Inputs come from a numpy seed and go through both packages. The JAX Pallas
kernels run as the JAX tests run them (interpret mode); the port's side is
the plain PyTorch version each kernel wrapper takes for CPU tensors. The
Hopper kernels themselves run only on the card (chip_smoke.py).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import ops as jops
from ray_tpu_torch import ops as tops
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as tflash
from ray_tpu_torch.ops import ragged_paged_attention as tragged

# module objects (ray_tpu.ops re-exports a function named flash_attention)
jflash = importlib.import_module("ray_tpu.ops.flash_attention")
jragged = importlib.import_module("ray_tpu.ops.ragged_paged_attention")

F32_TOL = 1e-6       # elementwise ops: same f32 formula, last-ulp differences
KERNEL_TOL = 2e-5    # f32 attention: different summation order of dots
BF16_TOL = 2e-2      # bf16 outputs: a few bf16 ulps at |x| ~ 1


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, dtype=np.float32), dtype)


def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    b = rng.standard_normal((32,)).astype(np.float32)
    np.testing.assert_allclose(
        tops.rms_norm(_t(x), _t(w)).numpy(), _np(jops.rms_norm(_j(x), _j(w))),
        atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(
        tops.layer_norm(_t(x), _t(w), _t(b)).numpy(),
        _np(jops.layer_norm(_j(x), _j(w), _j(b))), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("positions", ["none", "t", "bt"])
def test_rope_matches_jax(positions):
    rng = np.random.default_rng(1)
    B, T, H, D = 2, 6, 3, 16
    x = rng.standard_normal((B, T, H, D)).astype(np.float32)
    pos = {"none": None, "t": np.arange(3, 3 + T),
           "bt": rng.integers(0, 40, size=(B, T))}[positions]
    tc, ts = tops.rope_frequencies(D, 64, theta=500000.0)
    jc, js = jops.rope_frequencies(D, 64, theta=500000.0)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=F32_TOL, rtol=F32_TOL)
    got = tops.apply_rope(_t(x), tc, ts, positions=None if pos is None
                          else torch.from_numpy(pos))
    want = jops.apply_rope(_j(x), jc, js, positions=None if pos is None
                           else jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_activations_match_jax():
    rng = np.random.default_rng(2)
    g = rng.standard_normal((4, 33)).astype(np.float32)
    u = rng.standard_normal((4, 33)).astype(np.float32)
    for tf, jf in ((tops.swiglu, jops.swiglu), (tops.geglu, jops.geglu)):
        np.testing.assert_allclose(tf(_t(g), _t(u)).numpy(),
                                   _np(jf(_j(g), _j(u))), atol=F32_TOL,
                                   rtol=F32_TOL)
    np.testing.assert_allclose(tops.gelu(_t(g)).numpy(), _np(jops.gelu(_j(g))),
                               atol=F32_TOL, rtol=F32_TOL)


def test_attention_dispatcher_gqa_matches_jax():
    rng = np.random.default_rng(3)
    B, T, H, Hkv, D = 2, 32, 4, 2, 16
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    for causal in (True, False):
        want = jops.attention(_j(q), _j(k), _j(v), causal=causal)
        for impl in (None, "flash", "reference"):
            got = tops.attention(_t(q), _t(k), _t(v), causal=causal, impl=impl)
            np.testing.assert_allclose(got.numpy(), _np(want), atol=KERNEL_TOL,
                                       rtol=KERNEL_TOL)


def _flash_case(seed, *, B=1, H=4, Hkv=2, T=256, D=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    return q, k, v


def _jax_fwd(q, k, v, *, causal, dtype):
    """The Pallas forward in interpret mode on repeated kv heads."""
    n_rep = q.shape[1] // k.shape[1]
    kr, vr = (np.repeat(x, n_rep, axis=1) for x in (k, v))
    return jflash._fwd_call(_j(q, dtype), _j(kr, dtype), _j(vr, dtype),
                            causal=causal, scale=q.shape[-1] ** -0.5,
                            block_q=128, block_k=128, interpret=True)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas_interpret(causal):
    """Port's plain flash (the kernel's CPU version, GQA inputs) against the
    JAX kernel in interpret mode: O and lse at f32."""
    q, k, v = _flash_case(4)
    o_j, lse_j = _jax_fwd(q, k, v, causal=causal, dtype=jnp.float32)
    o_t, lse_t = tflash._fwd_call(_t(q), _t(k), _t(v), causal=causal,
                                  scale=q.shape[-1] ** -0.5)
    assert lse_t.shape == (1, 4, 256, 1) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(o_t.numpy(), _np(o_j), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)
    np.testing.assert_allclose(lse_t.numpy(), _np(lse_j), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)
    out = tops.flash_attention_forward(_t(q), _t(k), _t(v), causal=causal)
    assert torch.equal(out, o_t)


def test_flash_plain_bf16_matches_pallas_interpret():
    """bf16 inputs: both round O to bf16 once after f32 math."""
    q, k, v = _flash_case(5, T=128)
    o_j, lse_j = _jax_fwd(q, k, v, causal=True, dtype=jnp.bfloat16)
    o_t, lse_t = tflash._fwd_call(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                  _t(v, torch.bfloat16), causal=True,
                                  scale=q.shape[-1] ** -0.5)
    assert o_t.dtype == torch.bfloat16
    np.testing.assert_allclose(o_t.float().numpy(), _np(o_j), atol=BF16_TOL,
                               rtol=BF16_TOL)
    np.testing.assert_allclose(lse_t.numpy(), _np(lse_j), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [(128, 128), (128, 64)])
def test_flash_backward_plain_matches_pallas_interpret(causal, blocks):
    """Port's plain backward (GQA inputs, dk/dv per kv head) against the two
    Pallas backward kernels in interpret mode on repeated kv heads, with
    JAX's per-head dk/dv summed over each group; both fed JAX's (o, lse).
    Uneven blocks exercise the JAX kernels' causal liveness predicates."""
    q, k, v = _flash_case(8)
    do = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    scale = q.shape[-1] ** -0.5
    o, lse = _jax_fwd(q, k, v, causal=causal, dtype=jnp.float32)
    n_rep = q.shape[1] // k.shape[1]
    kr, vr = (np.repeat(x, n_rep, axis=1) for x in (k, v))
    jdq, jdk, jdv = jflash.flash_attention_backward(
        _j(q), _j(kr), _j(vr), o, lse, _j(do), causal=causal, scale=scale,
        block_q=blocks[0], block_k=blocks[1], interpret=True)
    dq, dk, dv = tflash.flash_attention_backward(
        _t(q), _t(k), _t(v), _t(np.array(o)), _t(np.array(lse)), _t(do),
        causal=causal, scale=scale)
    assert dk.shape == k.shape and dv.shape == v.shape

    def group_sum(x):  # [B, H, T, D] → [B, Hkv, T, D]
        x = _np(x)
        return x.reshape(x.shape[0], -1, n_rep, *x.shape[2:]).sum(2)

    for name, got, want in (("dq", dq, _np(jdq)), ("dk", dk, group_sum(jdk)),
                            ("dv", dv, group_sum(jdv))):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-4,
                                   err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_function_matches_autograd(causal):
    """FlashAttention on the CPU (plain forward and plain backward) against
    torch.autograd through the plain forward, GQA, strided views."""
    q, k, v = _flash_case(10, B=2, T=64, D=16)
    do = torch.from_numpy(
        np.random.default_rng(11).standard_normal(q.shape).astype(np.float32))

    def leaves():  # heads-major views of [B, T, H, D], as the dispatcher makes
        return [_t(x).transpose(1, 2).contiguous().transpose(1, 2)
                .requires_grad_() for x in (q, k, v)]

    a = leaves()
    out = tflash.flash_attention(*a, causal=causal)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, a, do)
    b = leaves()
    ref, _ = tflash.flash_attention_forward_plain(*b, causal=causal,
                                                  scale=16 ** -0.5)
    want = torch.autograd.grad(ref, b, do)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=1e-6, rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_cross_entropy_matches_jax(fused, z_loss):
    """softmax_cross_entropy on hidden @ head, and fused_head_cross_entropy
    (37 rows in chunks of 16, so the last chunk is padded), against the JAX
    ops: loss, n_valid and the gradients w.r.t. hidden and head, with some
    labels ignored."""
    rng = np.random.default_rng(12)
    N, E, V = 37, 16, 50
    hidden = rng.standard_normal((N, E)).astype(np.float32)
    head = (rng.standard_normal((E, V)) * 0.3).astype(np.float32)
    labels = rng.integers(0, V, size=N)
    labels[[0, 5, 36]] = -100

    def jloss(h, w):
        if fused:
            return jops.fused_head_cross_entropy(
                h, w, jnp.asarray(labels), z_loss=z_loss, chunk=16)
        return jops.softmax_cross_entropy(h @ w, jnp.asarray(labels),
                                          z_loss=z_loss)

    (want, jn), jgrads = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(_j(hidden), _j(head))
    h, w = _t(hidden).requires_grad_(), _t(head).requires_grad_()
    lab = torch.from_numpy(labels)
    if fused:
        got, n = tops.fused_head_cross_entropy(h, w, lab, z_loss=z_loss,
                                               chunk=16)
    else:
        got, n = tops.softmax_cross_entropy(h @ w, lab, z_loss=z_loss)
    assert float(n) == float(jn) == N - 3
    np.testing.assert_allclose(got.item(), float(want), atol=2e-5, rtol=2e-5)
    for g, jg in zip(torch.autograd.grad(got, (h, w)), jgrads):
        np.testing.assert_allclose(g.numpy(), _np(jg), atol=2e-5, rtol=2e-5)


def test_fused_cross_entropy_logits_spec_is_not_ported():
    """A logits_spec that splits the vocab needs a mesh over an initialised
    process group; the parity test over gloo ranks is in
    test_torch_spmd.py."""
    with pytest.raises(RuntimeError, match="needs a mesh"):
        tops.fused_head_cross_entropy(torch.zeros(4, 2), torch.zeros(2, 3),
                                      torch.zeros(4, dtype=torch.long),
                                      logits_spec=(None, "tp"))
    with pytest.raises(ValueError, match="rows are this rank's own"):
        tops.fused_head_cross_entropy(torch.zeros(4, 2), torch.zeros(2, 3),
                                      torch.zeros(4, dtype=torch.long),
                                      logits_spec=("tp",))


def _ragged_case(rng, *, B=8, Hkv=2, G=2, Dh=16, P=16, N=33, nb=4):
    """Twin of tests/test_ragged_attention.py::_rand_case."""
    q = rng.standard_normal((B, Hkv, G, Dh)).astype(np.float32)
    kp = rng.standard_normal((N, P, Hkv, Dh)).astype(np.float32)
    vp = rng.standard_normal((N, P, Hkv, Dh)).astype(np.float32)
    tbl = rng.integers(1, N, size=(B, nb)).astype(np.int32)
    # mixed positions: first page only, page boundaries, mid-page, full
    pos = np.asarray([0, 5, P - 1, P, 2 * P - 1, nb * P - 17, nb * P - 1,
                      10][:B], np.int32)
    return q, kp, vp, tbl, pos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ragged_plain_matches_pallas_interpret(seed):
    q, kp, vp, tbl, pos = _ragged_case(np.random.default_rng(seed))
    want = jragged.ragged_decode_attention(
        _j(q), _j(kp), _j(vp), jnp.asarray(tbl), jnp.asarray(pos),
        impl="kernel", interpret=True)
    args = (_t(q), _t(kp), _t(vp), torch.from_numpy(tbl), torch.from_numpy(pos))
    got = tops.ragged_decode_attention(*args)
    ref = tops.ragged_decode_attention_reference(*args, scale=16 ** -0.5)
    assert torch.equal(got, ref)  # CPU tensors take the plain version
    np.testing.assert_allclose(got.numpy(), _np(want), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)


def test_ragged_plain_bf16_matches_pallas_interpret():
    q, kp, vp, tbl, pos = _ragged_case(np.random.default_rng(9), Dh=64, G=4)
    bf = jnp.bfloat16
    want = jragged.ragged_decode_attention(
        _j(q, bf), _j(kp, bf), _j(vp, bf), jnp.asarray(tbl), jnp.asarray(pos),
        impl="kernel", interpret=True)
    got = tops.ragged_decode_attention(
        _t(q, torch.bfloat16), _t(kp, torch.bfloat16), _t(vp, torch.bfloat16),
        torch.from_numpy(tbl), torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("pps", [1, 3, 4])
def test_ragged_split_reference_matches_pallas_interpret(pps):
    """The kernel's split-and-merge arithmetic (plain mirror) against the
    JAX kernel in interpret mode at f32, nb = 4 pages split 1, 3 (not a
    divisor: the last split is short) and 4 at a time. Row 0 sits at pos 0,
    so every split but its first is empty; row 6 names an out-of-range page,
    which both clamp into the pool."""
    q, kp, vp, tbl, pos = _ragged_case(np.random.default_rng(20))
    assert pos[0] == 0 and tbl.shape[1] == 4
    tbl[6, 2] = kp.shape[0] + 3  # past the pool: clamps to the last page
    want = jragged.ragged_decode_attention(
        _j(q), _j(kp), _j(vp), jnp.asarray(tbl), jnp.asarray(pos),
        impl="kernel", interpret=True)
    args = (_t(q), _t(kp), _t(vp), torch.from_numpy(tbl), torch.from_numpy(pos))
    got = tragged.ragged_decode_attention_split_reference(
        *args, scale=16 ** -0.5, pages_per_split=pps)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)
    plain = tops.ragged_decode_attention(*args)  # CPU: the plain version
    np.testing.assert_allclose(plain.numpy(), _np(want), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)


def test_ragged_split_count_covers_the_table_without_reading_pos():
    """ragged_splits is a host function of (B, Hkv, nb, SM count) alone: at
    least one split, the splits cover the nb pages and none starts past
    them; at the serving shape (B=8, Hkv=8, nb=32 on 132 SMs) the split
    pass has at least two CTAs per SM."""
    import inspect

    assert list(inspect.signature(tragged.ragged_splits).parameters) == [
        "B", "Hkv", "nb", "sm_count"]
    for B in (1, 3, 8, 64):
        for Hkv in (1, 2, 8):
            for nb in (1, 2, 5, 16, 23, 32, 64):
                for sms in (1, 78, 132):
                    S, pps = tragged.ragged_splits(B, Hkv, nb, sms)
                    assert S >= 1 and pps >= 1
                    assert S * pps >= nb and (S - 1) * pps < nb
    S, pps = tragged.ragged_splits(8, 8, 32, 132)
    assert 8 * 8 * S >= tragged.CTAS_PER_SM * 132 and (S, pps) == (5, 7)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_backward_delta_matches_jax(dtype):
    """delta = rowsum(dO * O) as the plain backward takes it (and the dQ
    kernel computes it), against the JAX package's f32 delta
    (ray_tpu/ops/flash_attention.py::flash_attention_backward) on the same
    numpy inputs."""
    rng = np.random.default_rng(21)
    o = rng.standard_normal((2, 4, 64, 64)).astype(np.float32)
    do = rng.standard_normal(o.shape).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jo, jdo = _j(o, jdt), _j(do, jdt)
    want = (jdo.astype(jnp.float32) * jo.astype(jnp.float32)).sum(
        -1, keepdims=True)
    got = tflash.backward_delta(_t(o, tdt), _t(do, tdt))
    assert got.shape == (2, 4, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got[..., None].numpy(), _np(want),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    """The kernel paths launch or raise — a CPU tensor handed to them is
    refused, and only the device-dispatching entry points take the plain
    version. No launch is counted on the CPU."""
    kernels = (tflash.KERNEL, tflash.KERNEL_DKV, tflash.KERNEL_DQ,
               tragged.KERNEL)
    before = [k.launches for k in kernels]
    q, k, v = _flash_case(6, T=64)
    bq, bk, bv = (_t(x, torch.bfloat16) for x in (q, k, v))
    with pytest.raises(ValueError, match="CUDA"):
        tflash._fwd_kernel(bq, bk, bv, causal=True, scale=0.1)
    lse = torch.zeros(1, 4, 64, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tflash._bwd_kernel(bq, bk, bv, bq, lse, bq, causal=True, scale=0.1)
    rq, kp, vp, tbl, pos = _ragged_case(np.random.default_rng(0))
    with pytest.raises(ValueError, match="CUDA"):
        tragged._ragged_kernel_call(
            _t(rq, torch.bfloat16), _t(kp, torch.bfloat16),
            _t(vp, torch.bfloat16), torch.from_numpy(tbl),
            torch.from_numpy(pos), scale=0.25)
    with pytest.raises(ValueError, match="impl"):
        tops.ragged_decode_attention(_t(rq), _t(kp), _t(vp),
                                     torch.from_numpy(tbl),
                                     torch.from_numpy(pos), impl="kernel")
    assert [k.launches for k in kernels] == before


def _bad_layout(kind):
    """bf16 q, k, v (CPU) that the kernels must refuse, and the message."""
    B, H, Hkv, T, D = 1, 4, 2, 64, 64
    rng = np.random.default_rng(13)

    def act(heads, t=T, d=D, pad=0):  # [B,T,heads,D+pad] seen heads-major
        x = rng.standard_normal((B, t, heads, d + pad)).astype(np.float32)
        return _t(x, torch.bfloat16)[..., :d].transpose(1, 2)

    if kind == "stride_not_multiple_of_8":  # rows of 66 elements
        return (act(H, pad=2), act(Hkv), act(Hkv)), "positive multiples of 8"
    if kind == "base_misaligned":  # x[..., 1:]: one element off
        q = _t(rng.standard_normal((B, T, H, D + 8)), torch.bfloat16)
        return ((q[..., 1:D + 1].transpose(1, 2), act(Hkv), act(Hkv)),
                "16-byte alignment")
    if kind == "expanded_batch":  # stride 0: a broadcast, not a layout
        q = act(H)[:1].expand(2, -1, -1, -1)
        k, v = (act(Hkv).expand(2, -1, -1, -1) for _ in range(2))
        return (q, k, v), "positive multiples of 8"
    if kind == "head_dim_32":
        return (act(H, d=32), act(Hkv, d=32), act(Hkv, d=32)), "head_dim"
    if kind == "t_not_multiple_of_64":
        return (act(H, t=96), act(Hkv, t=96), act(Hkv, t=96)), "multiple of"
    raise AssertionError(kind)


@pytest.mark.parametrize("entry", ["fwd", "bwd"])
@pytest.mark.parametrize("kind", ["stride_not_multiple_of_8",
                                  "base_misaligned", "expanded_batch",
                                  "head_dim_32", "t_not_multiple_of_64"])
def test_kernel_wrappers_refuse_bad_layouts_and_count_nothing(kind, entry):
    """What the TMA tensor maps cannot describe is refused by the wrapper
    with a ValueError before the C entry point is reached, so no launch is
    counted (the C side checks the same again before encoding)."""
    (q, k, v), msg = _bad_layout(kind)
    kernels = (tflash.KERNEL, tflash.KERNEL_DKV, tflash.KERNEL_DQ)
    before = [x.launches for x in kernels]
    with pytest.raises(ValueError, match=msg):
        if entry == "fwd":
            tflash._fwd_kernel(q, k, v, causal=True, scale=0.125)
        else:
            B, H, T, _ = q.shape
            lse = torch.zeros(B, H, T, 1)
            tflash._bwd_kernel(q, k, v, q, lse, q, causal=True, scale=0.125)
    assert [x.launches for x in kernels] == before


@pytest.mark.parametrize("kind", ["stride_not_multiple_of_8",
                                  "base_misaligned"])
def test_kernel_wrappers_refuse_a_bad_o_layout_and_count_nothing(kind):
    """The dQ kernel reads O through a tensor map of its own: an O that the
    map cannot describe is refused with q, k, v and dO sound, before any
    launch is counted."""
    (bad, _, _), msg = _bad_layout(kind)  # [1, 4, 64, 64] seen heads-major
    q = torch.zeros(1, 4, 64, 64, dtype=torch.bfloat16)
    k = v = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16)
    kernels = (tflash.KERNEL, tflash.KERNEL_DKV, tflash.KERNEL_DQ)
    before = [x.launches for x in kernels]
    lse = torch.zeros(*q.shape[:3], 1)
    with pytest.raises(ValueError, match=msg):
        tflash._bwd_kernel(q, k, v, bad, lse, q, causal=True, scale=0.125)
    assert [x.launches for x in kernels] == before


@pytest.mark.parametrize("D", [64, 128])
def test_transposed_activation_views_fit_the_kernels(D):
    """The dispatcher's [B,T,H,D] → [B,H,T,D] views, heads-major contiguous
    tensors and empty_like outputs all pass the layout check, and such
    CPU tensors get as far as the device check."""
    x = torch.zeros(2, 192, 4, D, dtype=torch.bfloat16)
    view = x.transpose(1, 2)
    assert view.stride() == (192 * 4 * D, D, 4 * D, 1)
    for t in (view, view.contiguous(), torch.empty_like(view)):
        assert tflash._kernel_layout_ok(t)
    kv = torch.zeros(2, 192, 2, D, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tflash._fwd_kernel(view, kv, kv, causal=False, scale=D ** -0.5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_half_tile_matches_pallas_interpret(causal):
    """T = 192: a multiple of the callers' 64 but not of the kernels'
    128-row tiles. The plain forward and backward (what the card's kernels
    are held to) against the Pallas kernels at 64-row blocks."""
    q, k, v = _flash_case(14, T=192)
    do = np.random.default_rng(15).standard_normal(q.shape).astype(np.float32)
    scale = q.shape[-1] ** -0.5
    n_rep = q.shape[1] // k.shape[1]
    kr, vr = (np.repeat(x, n_rep, axis=1) for x in (k, v))
    o, lse = jflash._fwd_call(_j(q), _j(kr), _j(vr), causal=causal,
                              scale=scale, block_q=64, block_k=64,
                              interpret=True)
    o_t, lse_t = tflash._fwd_call(_t(q), _t(k), _t(v), causal=causal,
                                  scale=scale)
    np.testing.assert_allclose(o_t.numpy(), _np(o), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)
    np.testing.assert_allclose(lse_t.numpy(), _np(lse), atol=KERNEL_TOL,
                               rtol=KERNEL_TOL)
    jdq, jdk, jdv = jflash.flash_attention_backward(
        _j(q), _j(kr), _j(vr), o, lse, _j(do), causal=causal, scale=scale,
        block_q=64, block_k=64, interpret=True)
    dq, dk, dv = tflash.flash_attention_backward(
        _t(q), _t(k), _t(v), _t(np.array(o)), _t(np.array(lse)), _t(do),
        causal=causal, scale=scale)

    def group_sum(x):  # [B, H, T, D] → [B, Hkv, T, D]
        x = _np(x)
        return x.reshape(x.shape[0], -1, n_rep, *x.shape[2:]).sum(2)

    for name, got, want in (("dq", dq, _np(jdq)), ("dk", dk, group_sum(jdk)),
                            ("dv", dv, group_sum(jdv))):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-4,
                                   err_msg=name)


@pytest.mark.parametrize("nvcc_ok", [True, False])
def test_build_runs_one_nvcc_per_source_and_caches(tmp_path, monkeypatch,
                                                   nvcc_ok):
    """build_all with a stand-in nvcc: one compile per source, the library
    appears atomically under a source-hash name and is not rebuilt; a
    failing compile raises with nvcc's output and leaves no library."""
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    log = tmp_path / "calls.log"
    nvcc = bindir / "nvcc"
    body = ('out=""; while [ $# -gt 0 ]; do [ "$1" = -o ] && out="$2"; shift; '
            f'done; echo "$out" >> {log}; ')
    body += 'echo built > "$out"' if nvcc_ok else 'echo "error: bad"; exit 3'
    nvcc.write_text("#!/bin/sh\n" + body + "\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if not nvcc_ok:
        with pytest.raises(RuntimeError, match="error: bad"):
            _build.build_all()
        assert not list((tmp_path / "build").glob("*.so"))
        return
    logs = _build.build_all()
    assert sorted(logs) == _build.sources()
    built = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert built == sorted(_build._target(n).name for n in _build.sources())
    n = len(_build.sources())
    assert len(log.read_text().split()) == n
    assert _build.build_all() == {}  # cached: no second compile
    assert len(log.read_text().split()) == n


def test_build_names_every_kernel_source(tmp_path, monkeypatch):
    assert _build.sources() == ["flash_attention_bwd", "flash_attention_fwd",
                                "ragged_paged_attention"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.sources():
        target = _build._target(name)
        assert target.parent == _build.BUILD_DIR
        assert target.name.startswith(f"lib{name}-") and target.suffix == ".so"
    # a shared header is part of every source's build: editing it renames
    # (so rebuilds) every library
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    # both shared headers: mma_tiles.cuh (ragged decode) and
    # hopper_tiles.cuh (the flash kernels; ragged decode's exp2)
    for header in ("mma_tiles.cuh", "hopper_tiles.cuh"):
        before = {n: _build._target(n) for n in _build.sources()}
        with open(csrc / header, "a") as f:
            f.write("// edited\n")
        assert all(_build._target(n) != t for n, t in before.items())
