"""The port's int8 error-feedback wire compression against the JAX
package's.

Twins of tests/test_collective_quantized.py: block quantization and error
feedback as units (``pair``: both packages in turn, same numpy inputs,
equal outputs), then the compressed ring on each runtime (one
module-scoped session each): every rank reconstructs identical values, the
cumulative error telescopes, ~4x fewer bytes move, and destroying a group
releases its residuals.
"""

from __future__ import annotations

import numpy as np
import pytest

from torch_twins import kill_made, pair, same, start_sessions, sub


def _q(rt):
    return sub(rt, "util.collective.quantization")


def test_quantize_roundtrip_error_bound():
    def scn(rt):
        q = _q(rt)
        rng = np.random.default_rng(0)
        n = 40 * q.BLOCK
        x = rng.standard_normal(n).astype(np.float32) * 3.0
        back = q.dequantize_block(q.quantize_block(x))
        step = np.abs(x.reshape(-1, q.BLOCK)).max(axis=1) / 127.0
        err = np.abs(back - x).reshape(-1, q.BLOCK)
        return (str(back.dtype), back.shape,
                bool((err <= step[:, None] * 0.5 + 1e-7).all()),
                back.tobytes())

    got = pair(scn)
    assert got[:3] == ("float32", (40 * _q(__import__("ray_tpu")).BLOCK,),
                       True)


def test_quantize_wire_bytes_ratio():
    def scn(rt):
        x = np.ones((1 << 18,), np.float32)
        return x.nbytes / _q(rt).quantize_block(x).wire_bytes

    assert pair(scn) > 3.8


def test_quantize_zero_block_and_padding():
    def scn(rt):
        q = _q(rt)
        x = np.zeros((300,), np.float32)
        zero_exact = bool((q.dequantize_block(q.quantize_block(x)) == x)
                          .all())
        y = np.arange(5, dtype=np.float64)
        back = q.dequantize_block(q.quantize_block(y))
        return (zero_exact, str(back.dtype),
                bool(np.allclose(back, y, atol=4 / 127.0, rtol=0)),
                back.tolist())

    assert pair(scn)[:3] == (True, "float64", True)


def test_error_feedback_telescopes_at_one_site():
    def scn(rt):
        q = _q(rt)
        rng = np.random.default_rng(1)
        x = rng.standard_normal(2048).astype(np.float32)
        outs = []
        for _ in range(30):
            c = q.quantize_with_feedback(x, "efg", "k", "site")
            outs.append(q.dequantize_block(c))
        q.release_group_residuals("efg")
        outs = np.stack(outs)
        one_round = np.abs(outs[0] - x).max()
        cum = np.abs(outs.sum(0) - 30 * x).max()
        return (bool(cum <= 2 * one_round + 1e-6),
                bool(np.abs(outs.mean(0) - x).max() <= one_round / 8),
                outs.tobytes())

    assert pair(scn)[:2] == (True, True)


def test_compression_validation():
    def scn(rt):
        rt.shutdown()
        rt.init(local_mode=True)
        col = sub(rt, "util.collective")
        try:
            col.init_collective_group(1, 0, group_name="val")
            x32 = np.ones((8,), np.float32)
            out = []
            for kw, arr in (({"compression": "fp8"}, x32),
                            ({"op": "max", "compression": "int8_block"}, x32),
                            ({"compression": "int8_block"},
                             np.ones((8,), np.int64))):
                with pytest.raises(ValueError) as ei:
                    col.allreduce(arr, group_name="val", **kw)
                out.append(str(ei.value))
            col.destroy_collective_group("val")
            return out
        finally:
            rt.shutdown()

    msgs = pair(scn)
    for msg, what in zip(msgs, ("unknown compression", "only composes",
                                "floating")):
        assert what in msg, msg


# -------------------------------------------------------------- ring level


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=32, num_workers=2, max_workers=16)
    yield pkgs
    for rt in pkgs:
        rt.shutdown()


def _q_worker(rt):
    """The reference's QWorker on package `rt` (pickled by value)."""
    pkg = rt.__name__

    @rt.remote
    class QWorker:
        def init_collective_group(self, world_size, rank, backend,
                                  group_name):
            import importlib

            self.col = importlib.import_module(pkg + ".util.collective")
            self.q = importlib.import_module(
                pkg + ".util.collective.quantization")
            self.met = importlib.import_module(pkg + ".util.metrics")
            self.col.init_collective_group(world_size, rank, backend=backend,
                                           group_name=group_name)
            self.rank = rank
            self.g = group_name

        def repeated_allreduce(self, n, rounds, op="sum"):
            rng = np.random.default_rng(100 + self.rank)
            x = rng.standard_normal(n).astype(np.float32)
            outs = [self.col.allreduce(x, op=op, compression="int8_block",
                                       group_name=self.g, timeout=120.0)
                    for _ in range(rounds)]
            exact = self.col.allreduce(x, op=op, group_name=self.g,
                                       timeout=120.0)
            return np.stack(outs), exact

        def quant_reducescatter_flat(self, n):
            x = np.full((n,), float(self.rank + 1), np.float32)
            s = self.col.reducescatter_flat(x, op="mean", group_name=self.g,
                                            compression="int8_block",
                                            timeout=120.0)
            return s.chunk, s.index, s.chunk_size, s.total_size

        def quant_allgather(self, shape):
            x = np.full(shape, float(self.rank) + 0.25, np.float32)
            outs = self.col.allgather(x, group_name=self.g,
                                      compression="int8_block", timeout=120.0)
            return [np.asarray(o) for o in outs]

        def wire_bytes_by_compression(self):
            c = self.met.get_or_create(self.met.Counter,
                                       "ray_tpu_collective_bytes_total")
            out = {}
            for tags, val in c._snapshot_series():
                comp = dict(tags).get("compression", "none")
                out[comp] = out.get(comp, 0.0) + val
            return out

        def residuals(self):
            return self.q.residual_count(self.g)

        def destroy(self):
            self.col.destroy_collective_group(self.g)
            return self.q.residual_count(self.g)

    return QWorker


def _mkgroup(rt, n, name):
    ws = [_q_worker(rt).remote() for _ in range(n)]
    _made.setdefault(rt.__name__, []).extend(ws + [name])
    sub(rt, "util.collective").create_collective_group(
        ws, n, list(range(n)), group_name=name)
    return ws


def _same(pkgs, scn, want=None):
    """Both runtimes; then every actor the scenario made is killed."""
    try:
        return same(pkgs, scn, want, serve_cleanup=False)
    finally:
        kill_made(pkgs, _made)


_made: dict = {}


def test_quantized_allreduce_consistent_and_telescoping(pkgs):
    def scn(rt):
        ws = _mkgroup(rt, 2, "q2")
        (o0, e0), (o1, e1) = rt.get(
            [w.repeated_allreduce.remote(5000, 10) for w in ws], timeout=240)
        one_round = np.abs(o0[0] - e0).max()
        return (bool((o0 == o1).all()), bool((e0 == e1).all()),
                bool(one_round > 0),
                bool(np.abs(o0.sum(0) - 10 * e0).max()
                     <= 3 * one_round + 1e-5),
                bool(np.abs(o0.mean(0) - e0).max() <= one_round / 2),
                o0.tobytes())

    assert _same(pkgs, scn)[:5] == (True,) * 5


def test_quantized_allreduce_world4_mean(pkgs):
    def scn(rt):
        ws = _mkgroup(rt, 4, "q4")
        outs = rt.get(
            [w.repeated_allreduce.remote(3000, 4, "mean") for w in ws],
            timeout=300)
        ref = outs[0][1]
        scale = np.abs(ref).max()
        return ([bool((e == ref).all()) for _, e in outs],
                [bool((o == outs[0][0]).all()) for o, _ in outs],
                [bool(np.abs(o[-1] - e).max() < 0.05 * max(scale, 1.0))
                 for o, e in outs], outs[0][0].tobytes())

    assert _same(pkgs, scn)[:3] == ([True] * 4,) * 3


def test_quantized_moves_at_least_3x_fewer_bytes(pkgs):
    def scn(rt):
        ws = _mkgroup(rt, 2, "qbytes")
        rt.get([w.repeated_allreduce.remote(1 << 18, 1) for w in ws],
               timeout=240)
        by = rt.get(ws[0].wire_bytes_by_compression.remote())
        return by["none"] >= 3.0 * by["int8_block"], by

    ok, by = _same(pkgs, scn)
    assert ok, by


def test_quantized_reducescatter_flat_and_allgather(pkgs):
    def scn(rt):
        ws = _mkgroup(rt, 2, "qrsf")
        rs = rt.get([w.quant_reducescatter_flat.remote(1000) for w in ws],
                    timeout=240)
        ag = rt.get([w.quant_allgather.remote((40, 10)) for w in ws],
                    timeout=240)
        return ({o[1] for o in rs},
                [(per, total, bool(np.allclose(chunk, 1.5, atol=0.05)))
                 for chunk, _, per, total in rs],
                [bool((ag[0][r] == ag[1][r]).all()) for r in (0, 1)],
                [(ag[0][r].shape,
                  bool(np.allclose(ag[0][r], r + 0.25, atol=0.02)))
                 for r in (0, 1)],
                [c.tobytes() for c, *_ in rs])

    got = _same(pkgs, scn)
    assert got[:4] == ({0, 1}, [(500, 1000, True)] * 2, [True, True],
                       [((40, 10), True)] * 2)


def test_destroy_releases_error_feedback_residuals(pkgs):
    def scn(rt):
        ws = _mkgroup(rt, 2, "qleak")
        rt.get([w.repeated_allreduce.remote(2000, 2) for w in ws],
               timeout=240)
        counts = rt.get([w.residuals.remote() for w in ws])
        return all(c > 0 for c in counts), rt.get(
            [w.destroy.remote() for w in ws])

    _same(pkgs, scn, (True, [0, 0]))
