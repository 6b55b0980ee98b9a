"""Operation counts against hand-worked shapes of PERF.md's kernel table
(its bound = max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s)) and against the
port's own training count."""

import json
import os

import pytest

from gpubench import ops, weights
from gpubench.ops import counts

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def bound_ms(work):
    return 1e3 * ops.bound_seconds(*work)


def test_flash_forward_matches_the_kernel_table():
    # [4,32,2048,64] causal: 0.0695 ms, FLOP-bound
    w = counts.flash_fwd([2048] * 4, 32, 32, 64)
    assert bound_ms(w) == pytest.approx(0.0695, abs=5e-5)
    assert w[0] / 989e12 > w[1] / 3.35e12
    # [1,32,1024,128] causal, Llama-3-8B's 8 kv heads: 0.0087 ms
    assert bound_ms(counts.flash_fwd([1024], 32, 8, 128)) == \
        pytest.approx(0.0087, abs=5e-5)
    # [1,16,2048,128] causal, 4 kv heads: 0.0174 ms
    assert bound_ms(counts.flash_fwd([2048], 16, 4, 128)) == \
        pytest.approx(0.0174, abs=5e-5)


def test_flash_backward_is_five_matmuls():
    f = counts.flash_fwd([2048] * 4, 32, 32, 64)
    b = counts.flash_bwd([2048] * 4, 32, 32, 64)
    assert b[0] == 2.5 * f[0]
    # reads q, k, v, o, dO, lse; writes dq, dk, dv, delta
    T, H, D = 2048, 32, 64
    assert b[1] == 4 * T * (8 * H * D * 2 + 2 * H * 4)


def test_ragged_decode_matches_the_kernel_table():
    # B=8, Hkv=8, G=4, Dh=128, P=64, 32 pages, all rows full: 0.0201 ms
    w = counts.ragged_decode([32 * 64] * 8, 32, 8, 128, 1)
    assert bound_ms(w) == pytest.approx(0.0201, abs=1e-4)
    assert w[1] / 3.35e12 > w[0] / 989e12


def test_mixtral_token_flops_by_hand():
    with open(os.path.join(CONFIGS, "mixtral-8x7b-l16.json")) as f:
        d = weights.dims(json.load(f))
    E, F = 4096, 14336
    attn = 2 * E * (32 + 16) * 128 + 2 * 32 * 128 * E
    mlp = 2 * E * 8 + 2 * 3 * 2 * E * F
    assert counts.token_matmul_flops(d) == 16 * (attn + mlp)
    # ~13 GFLOP a token through the 16 layers, the head 0.26
    assert 11e9 < counts.token_matmul_flops(d) < 13e9
    assert counts.head_flops(d) == 2 * E * 32000


def test_train_count_is_the_ports():
    from ray_tpu_torch.benchmarks.train_step import flops_per_token
    from ray_tpu_torch.models import gpt2_config

    with open(os.path.join(CONFIGS, "gpt2-xl.json")) as f:
        d = weights.dims(json.load(f))
    cfg = gpt2_config("1.5b")
    ours = counts.train_flops_per_token(cfg.num_params(), d, 1024)
    assert ours == flops_per_token(cfg, 1024)[1]


def test_kernel_files_name_the_operations():
    assert ops.kernel_names("flash_fwd") == ["flash_fwd_kernel"]
    assert ops.kernel_names("flash_bwd") == ["flash_bwd_dkv_kernel",
                                             "flash_bwd_dq_kernel"]
    secs = {"void flash_fwd_kernel<64>": 0.5, "ampere_gemm": 2.0,
            "void ragged_split_kernel<128, 64>(...)": 0.25}
    assert ops.device_seconds("flash_fwd", secs) == 0.5
    assert ops.device_seconds("ragged_decode", secs) == 0.25
    assert ops.device_seconds("flash_bwd", secs) is None
    assert ops.roofline_pct([(989e12, 0)], 2.0) == pytest.approx(50.0)
    assert ops.roofline_pct([], 1.0) is None


@pytest.mark.parametrize("port, fwd_layers", [
    ({"remat": True, "remat_policy": "nothing"}, 4),
    ({"remat": True, "remat_policy": "dots"}, 4),
    ({"remat": True, "remat_policy": "pairs"}, 3),
    ({"remat": False}, 2)])
def test_train_flash_roofline_counts_the_recomputed_forward(port, fwd_layers):
    from gpubench.common import metric_file, load_module

    reader = load_module(metric_file("flash_roofline.train"), "flash_train")
    with open(os.path.join(CONFIGS, "gpt2-xl.json")) as f:
        cfg = dict(json.load(f), n_layer=2, port=port)
    layer = {"cfg": cfg, "seq": 1024, "batch": 2,
             "trace": {"steps": 3, "kernel_s": {
                 "void flash_fwd_kernel<64>": 0.01,
                 "void flash_bwd_dq_kernel<64>": 0.01,
                 "void flash_bwd_dkv_kernel<64>": 0.02}}}
    rows = [1024] * 6
    work = [counts.flash_fwd(rows, 25, 25, 64, fwd_layers),
            counts.flash_bwd(rows, 25, 25, 64, 2)]
    assert reader.read(layer) == pytest.approx(ops.roofline_pct(work, 0.04))
