"""The attention dispatcher's automatic choice (ray_tpu_torch.ops.attention
with impl=None): the flash kernels exactly where ``kernel_fits`` holds, the
dense reference everywhere else, decided from device, dtype and shape
before any call. The device part of the rule is tested through the pure
predicate ``_fits(shape, dtypes, is_cuda)``, so the table runs on the
CPU."""

import importlib

import numpy as np
import pytest
import torch

from ray_tpu_torch import ops as tops
from ray_tpu_torch.ops import flash_attention as tflash

# the module, which the package's attention() function shadows by name
tattn = importlib.import_module("ray_tpu_torch.ops.attention")


def _heads_major(T, D, dtype, heads, device="cpu"):
    """[1, T, heads, D] activations seen heads-major, as the dispatcher
    hands them to the kernels."""
    return torch.zeros((1, T, heads, D), dtype=dtype,
                       device=device).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T", [64, 100, 197, 2048])
def test_kernel_choice_table(T, D, dtype):
    """On CUDA the kernels are chosen iff the tensors are bf16, D is 64 or
    128 and T is a multiple of 64; off CUDA never. The wrappers' own checks
    refuse exactly the shapes and dtypes the predicate refuses."""
    want = dtype == torch.bfloat16 and D in (64, 128) and T % 64 == 0
    dtypes = {"q": dtype, "k": dtype, "v": dtype}
    assert tflash._fits((1, 4, T, D), dtypes, True) is want
    assert tflash._fits((1, 4, T, D), dtypes, False) is False
    for device in ("meta", "cpu"):
        q = _heads_major(T, D, dtype, 4, device)
        kv = _heads_major(T, D, dtype, 2, device)
        assert tflash.kernel_fits(q, kv, kv) is False
    # the wrappers' checks agree: a fit gets as far as the device check, a
    # misfit is refused for its shape (ValueError) or else its dtype
    # (TypeError), as impl="flash" still is on the card
    q, kv = _heads_major(T, D, dtype, 4), _heads_major(T, D, dtype, 2)
    shape_ok = D in (64, 128) and T % 64 == 0
    with pytest.raises(TypeError if shape_ok and not want else ValueError,
                       match="CUDA" if want else None) as err:
        tflash._fwd_kernel(q, kv, kv, causal=True, scale=D ** -0.5)
    assert ("CUDA" in str(err.value)) is want, str(err.value)


def test_kernel_fits_needs_every_input_bf16():
    shape = (1, 4, 128, 64)
    bf = torch.bfloat16
    assert tflash._fits(shape, {"q": bf, "k": bf, "v": bf}, True)
    assert not tflash._fits(shape, {"q": bf, "k": bf, "v": torch.float32},
                            True)
    assert not tflash._fits(shape, {"q": bf, "k": torch.float16, "v": bf},
                            True)


@pytest.mark.parametrize("fits", [True, False])
def test_dispatcher_takes_the_kernels_iff_they_fit(monkeypatch, fits):
    """The dispatcher's wiring, with the predicate answering as it would on
    the card: a fitting call goes through FlashAttention (its plain version
    on CPU tensors), any other to the reference; both give the reference's
    numbers."""
    calls = []
    real_apply = tflash.FlashAttention.apply

    def spy_apply(*args):
        calls.append("flash")
        return real_apply(*args)

    monkeypatch.setattr(tattn, "kernel_fits",
                        lambda q, k, v: fits and tflash._fits(
                            q.shape, {"q": q.dtype, "k": k.dtype,
                                      "v": v.dtype}, True))
    monkeypatch.setattr(tattn.FlashAttention, "apply", spy_apply)
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 64, 4, 64))).to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((2, 64, 2, 64))).to(torch.bfloat16)
    got = tops.attention(q, k, k, causal=True)
    assert calls == (["flash"] if fits else [])
    want = tops.attention(q, k, k, causal=True, impl="reference")
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=2e-2, rtol=2e-2)
    calls.clear()
    # T = 100 and f32 never fit, whatever the device
    tops.attention(q[:, :50].float(), k[:, :50].float(), k[:, :50].float())
    tops.attention(q.float(), k.float(), k.float())
    assert calls == []


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [64, 100])
def test_cpu_auto_path_is_the_reference(T, dtype):
    """CPU calls with impl=None take the dense reference, as before."""
    rng = np.random.default_rng(T)
    q = torch.from_numpy(rng.standard_normal((1, T, 4, 64))).to(dtype)
    k = torch.from_numpy(rng.standard_normal((1, T, 2, 64))).to(dtype)
    v = torch.from_numpy(rng.standard_normal((1, T, 2, 64))).to(dtype)
    for causal in (True, False):
        got = tops.attention(q, k, v, causal=causal)
        want = tops.attention(q, k, v, causal=causal, impl="reference")
        assert torch.equal(got, want)
        ref = tops.reference_attention(q, k.repeat_interleave(2, dim=2),
                                       v.repeat_interleave(2, dim=2),
                                       causal=causal)
        assert torch.equal(got, ref)
