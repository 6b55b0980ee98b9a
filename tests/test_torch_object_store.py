"""The port's object store and serialization against the JAX package's.

- torch tensors (f32, bf16, int64, 0-dim, non-contiguous, expanded, nested
  in a dict) through put/get and task args/returns in both runtimes (the
  JAX package pickles a tensor with torch's own reducer, the port sends
  its bytes out of band): the same values, dtypes, shapes and strides;
- above the inline limit the port's CPU tensor is a zero-copy view of the
  store, tethered to its pin like numpy's;
- a CUDA tensor reaching a process with no card raises, naming num_gpus;
- twins of tests/test_shm_arena.py on the port's arena (its own copy of
  the C++ source, built into ray_tpu_torch/build/), the C-level suite
  included, and of the session end to end on both backends;
- after shutdown no /dev/shm/rtpt_* segment of the session is left, and no
  rtpu_* one was created by the port.
"""

from __future__ import annotations

from functools import partial

import glob
import os
import subprocess
import sys
import uuid

import numpy as np
import pytest
import torch

from torch_twins import twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arenas():
    from ray_tpu._private import shm_arena as jarena
    from ray_tpu_torch._private import shm_arena as tarena

    return jarena, tarena


@pytest.fixture(scope="module")
def pkgs():
    import ray_tpu
    import ray_tpu_torch

    out = (ray_tpu, ray_tpu_torch)
    for rt in out:
        rt.shutdown()
        rt.init(num_cpus=4, num_workers=2, max_workers=4)
    yield out
    for rt in out:
        rt.shutdown()


_twin = partial(twin, serve_cleanup=False)


def _tensors():
    g = torch.Generator().manual_seed(0)
    base = torch.randn(64, 48, generator=g)
    return {
        "f32": torch.randn(300, 7, generator=g),
        "bf16": torch.randn(33, 65, generator=g).to(torch.bfloat16),
        "int64": torch.arange(-50, 50, dtype=torch.int64).reshape(4, 25),
        "scalar": torch.tensor(3.25),
        "transposed": base.t(),
        "strided": base[::3, 5:40:2],
        "expanded": torch.arange(6.0).expand(5, 6),
        "big": torch.randn(1 << 18, generator=g),  # 1 MiB: the shm path
        "nested": {"a": [torch.ones(3, dtype=torch.bfloat16), 7],
                   "b": (torch.zeros(2, 2, dtype=torch.int32),)},
    }


def _describe(x):
    """Everything a tensor round trip must keep."""
    if isinstance(x, torch.Tensor):
        return (str(x.dtype), tuple(x.shape), tuple(x.stride()),
                x.float().numpy().tobytes())
    if isinstance(x, dict):
        return {k: _describe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x).__name__, [_describe(v) for v in x]
    return x


def _scn_tensor_roundtrip(rt):
    ts = _tensors()

    @rt.remote
    def echo(x):
        return x

    @rt.remote
    def make():
        import torch

        return {"bf16": torch.full((4, 130), 1.5, dtype=torch.bfloat16).t(),
                "big": torch.arange(1 << 18, dtype=torch.float32)}

    put = {k: rt.get(rt.put(v)) for k, v in ts.items()}
    args = rt.get(echo.remote(ts))
    return _describe(put), _describe(args), _describe(rt.get(make.remote()))


def test_tensors_through_put_get_and_task_args_and_returns(pkgs):
    jax_side, port_side = _twin(pkgs, _scn_tensor_roundtrip)
    assert port_side == jax_side
    want = _describe(_tensors())
    assert port_side[0] == want and port_side[1] == want
    # strides survive: the transposed view and the gapped slice keep theirs
    assert want["transposed"][2] == (1, 48)
    assert want["strided"][2] == (144, 2)


def test_large_cpu_tensor_is_zero_copy_and_tethered(pkgs):
    """Above the inline limit a CPU tensor read from the store aliases the
    store's bytes (two gets share one buffer), and the view keeps its store
    pin: once the ref is freed and other objects are put, its values are
    intact (a freed pin would let the arena recycle the slot)."""
    import gc

    import ray_tpu_torch as rt

    import time

    x = torch.arange(1 << 20, dtype=torch.float32)
    ref = rt.put(x)
    oid = ref.hex()
    a, b = rt.get(ref), rt.get(ref)
    assert a.data_ptr() == b.data_ptr()
    assert torch.equal(a, x)
    store = rt._private.api._get_worker().store
    del ref, b
    gc.collect()
    deadline = time.monotonic() + 10
    while store.contains(oid):  # the free reached the store
        assert time.monotonic() < deadline
        time.sleep(0.02)
    keep = [rt.put(torch.full((1 << 20,), float(i))) for i in range(8)]
    assert torch.equal(a, x)
    del keep


def test_a_cuda_tensor_never_becomes_a_cpu_tensor():
    """A CUDA tensor that reaches a process with no card raises, naming
    num_gpus; the receiving side never hands back a CPU tensor."""
    from ray_tpu_torch._private import serialization as ser

    host = np.zeros(16, np.uint8)
    if torch.cuda.is_available():
        pytest.skip("this process sees a GPU")
    with pytest.raises(ser.DeviceUnavailableError, match="num_gpus"):
        ser._rebuild_tensor(host, "float32", (4,), (1,), True, False, False)


def test_the_runtime_does_not_import_torch():
    """A payload without tensors round-trips in a process that never
    imported torch, and serialization does not import it."""
    code = ("import sys; from ray_tpu_torch._private import serialization "
            "as s; import numpy as np; "
            "v = s.loads(s.dumps({'a': np.arange(5), 'b': [1, 'x']})); "
            "print(v['a'].tolist(), 'torch' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.stdout.strip() == "[0, 1, 2, 3, 4] False", r.stderr


def test_parameter_and_requires_grad_survive():
    from ray_tpu_torch._private import serialization as ser

    p = torch.nn.Parameter(torch.randn(3, 4))
    q = ser.loads(ser.dumps({"p": p, "g": torch.ones(2).requires_grad_()}))
    assert isinstance(q["p"], torch.nn.Parameter) and q["p"].requires_grad
    assert torch.equal(q["p"].detach(), p.detach())
    assert q["g"].requires_grad


# ------------------------------------------------------ test_shm_arena twins


def test_c_level_suite(tmp_path):
    """The port's copy of the native test binary, against the port's own
    library (symbols rtpt_*), built from ray_tpu_torch/csrc."""
    _, tarena = _arenas()
    tarena._ensure_lib()
    assert os.path.realpath(tarena._LIB).startswith(
        os.path.join(REPO, "ray_tpu_torch", "build"))
    test_bin = str(tmp_path / "shm_store_test")
    subprocess.run(
        ["g++", "-O2", "-o", test_bin,
         os.path.join(REPO, "ray_tpu_torch", "csrc", "shm_store_test.cc"),
         "-ldl", "-lpthread"], check=True, capture_output=True)
    arena = f"/dev/shm/rtpt_ctest_{uuid.uuid4().hex[:8]}"
    r = subprocess.run([test_bin, os.path.abspath(tarena._LIB), arena],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr


def _on_both(scenario):
    """scenario(ArenaStore module) on a fresh 1 MiB arena of each package."""
    out = []
    for mod in _arenas():
        st = mod.ArenaStore(f"t{uuid.uuid4().hex[:8]}", capacity=1 << 20)
        try:
            out.append(scenario(st, mod))
        finally:
            st.cleanup_session()
    assert out[0] == out[1], out
    return out[1]


def _roundtrip_bytes(arena, _mod):
    data = bytes(range(256)) * 16
    arena.put_parts("obj1", [data], len(data))
    got = arena.get("obj1")
    out = [bytes(got.buf) == data, arena.contains("obj1"),
           arena.size("obj1")]
    got.release()
    arena.delete("obj1")
    return out + [arena.contains("obj1")]


def test_roundtrip_bytes():
    assert _on_both(_roundtrip_bytes) == [True, True, 4096, False]


def _zero_copy_numpy(arena, _mod):
    a = np.arange(1000, dtype=np.float32)
    raw = a.tobytes()
    arena.put_parts("arr", [raw], len(raw))
    obj = arena.get("arr")
    view = np.frombuffer(obj.buf, dtype=np.float32)
    same = bool(np.array_equal(view, a))
    del view
    obj.release()
    return same


def test_zero_copy_numpy_view():
    assert _on_both(_zero_copy_numpy) is True


def _eviction(arena, _mod):
    evicted = []
    arena.on_evict = evicted.extend
    for i in range(12):
        data = bytes([i]) * (128 * 1024)
        arena.put_parts(f"o{i}", [data], len(data))
    return [arena.tier_of("o0"), "o0" in evicted, arena.tier_of("o11"),
            bytes(arena.get("o11").buf[:1]), bytes(arena.get("o0").buf[:1])]


def test_eviction_under_pressure():
    assert _on_both(_eviction) == ["spill", True, "shm", b"\x0b", b"\x00"]


def _reput_deferred(arena, _mod):
    data = b"g" * 8192
    arena.put_parts("ghost", [data], len(data))
    view = arena.get("ghost")   # pin…
    arena.delete("ghost")       # …so the delete is deferred
    out = [arena.tier_of("ghost"),
           arena.put_parts("ghost", [data], len(data)),
           bytes(arena.get("ghost").buf) == data]
    view.release()
    return out + [bytes(arena.get("ghost").buf) == data]


def test_reput_of_deferred_deleted_object_preserves_data():
    assert _on_both(_reput_deferred) == [None, "spill", True, True]


def _pin_and_die(module, session_id):
    # spawn target (module-level so it pickles): pin and vanish
    import importlib

    st = importlib.import_module(module).ArenaStore(session_id,
                                                    capacity=1 << 20)
    view = st.get("held")  # pin (held ref: GC must not release it)…
    assert view.buf[:1] == b"d"
    os._exit(0)            # …and vanish without releasing


def _dead_reader(arena, mod):
    import multiprocessing

    data = b"d" * (256 * 1024)
    arena.put_parts("held", [data], len(data))
    ctx = multiprocessing.get_context("spawn")
    p = ctx.Process(target=_pin_and_die, args=(mod.__name__,
                                               arena.session_id))
    p.start()
    p.join(timeout=60)
    return [p.exitcode, arena.reap_dead_pins(), arena.reap_dead_pins()]


def test_dead_reader_pins_are_reaped():
    assert _on_both(_dead_reader) == [0, 1, 0]


def _release_pid_pins(arena, _mod):
    data = b"v" * 4096
    arena.put_parts("view", [data], len(data))
    v1, v2 = arena.get("view"), arena.get("view")
    out = [arena.release_pid_pins(), v1._released, v2._released]
    v1.release()  # a no-op, not a double unpin
    arena.delete("view")
    return out + [arena.contains("view")]


def test_release_pid_pins_neuter_outstanding_views():
    assert _on_both(_release_pid_pins) == [2, True, True, False]


def _too_large(arena, _mod):
    data = b"x" * (2 << 20)
    arena.put_parts("huge", [data], len(data))
    return [arena.contains("huge"), bytes(arena.get("huge").buf[:4]),
            arena.size("huge")]


def test_too_large_goes_to_spill_tier():
    assert _on_both(_too_large) == [True, b"xxxx", 2 << 20]


def _pinned_survives(arena, mod):
    data = b"p" * (256 * 1024)
    arena.put_parts("pin", [data], len(data))
    held = arena.get("pin")
    for i in range(12):
        try:
            arena.put_parts(f"f{i}", [b"f" * (128 * 1024)], 128 * 1024)
        except mod.ArenaFullError:
            pass
    out = [arena.contains("pin"), bytes(held.buf[:1])]
    held.release()
    return out


def test_pinned_object_survives():
    assert _on_both(_pinned_survives) == [True, b"p"]


def test_arena_segments_carry_each_packages_prefix():
    jarena, tarena = _arenas()
    sid = f"t{uuid.uuid4().hex[:8]}"
    st = tarena.ArenaStore(sid, capacity=1 << 20)
    try:
        st.put_parts("x", [b"1"], 1)
        assert glob.glob(f"/dev/shm/rtpt_{sid}*")
        assert not glob.glob(f"/dev/shm/rtpu_{sid}*")
    finally:
        st.cleanup_session()
    assert not glob.glob(f"/dev/shm/rtpt_{sid}*")


_SESSION = """
import glob, os, sys
import numpy as np
import torch
import {pkg} as rt
info = rt.init(num_cpus=4, num_workers=2, max_workers=4)
sid = info["session_id"]

@rt.remote
def double(x):
    return x * 2

big = np.ones((512, 512), dtype=np.float32)  # 1 MiB: via shm
ref = rt.put(big)
out = [float(rt.get(double.remote(rt.get(ref)[0, 0]))),
       bool(np.array_equal(rt.get(ref), big)),
       rt.get([double.remote(i) for i in range(20)]) == [i * 2 for i in range(20)]]
t = torch.arange(1 << 18, dtype=torch.float32).reshape(512, 512).t()
got = rt.get(double.remote(rt.put(t)))
out += [bool(torch.equal(got, t * 2)), tuple(rt.get(rt.put(t)).stride())]
live = bool(glob.glob(f"/dev/shm/{{prefix}}{{sid}}*"))
rt.shutdown()
left = glob.glob(f"/dev/shm/{{prefix}}{{sid}}*")
print(out, live, left)
"""


@pytest.mark.parametrize("backend", ["arena", "file"])
def test_session_end_to_end_on_each_backend(backend):
    """A full session of each package on the store backend (one process a
    package: the backend is chosen at init): the same values, tensors and
    strides, live segments under each package's own prefix, and none left
    after shutdown."""
    outs = []
    for pkg, prefix, key in (("ray_tpu", "rtpu_", "RAY_TPU_STORE_BACKEND"),
                             ("ray_tpu_torch", "rtpt_",
                              "RAY_TPU_TORCH_STORE_BACKEND")):
        env = {**os.environ, "PYTHONPATH": REPO, key: backend}
        code = _SESSION.format(pkg=pkg).replace("{prefix}", prefix)
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-3000:]
        outs.append(r.stdout.strip().splitlines()[-1])
    assert outs[0] == outs[1]
    assert outs[1] == "[2.0, True, True, True, (1, 512)] True []"


@pytest.mark.parametrize("backend", ["arena", "file"])
def test_transfer_plane_serves_both_tiers(backend, monkeypatch):
    """Twin of tests/test_store_backends.py::test_transfer_plane_serves_both_tiers:
    the chunked TCP plane serves arena objects from pinned views (releasing
    the pin after the send) and spilled objects from disk, and the port's
    ObjectFetcher pulls both, in each package on each backend."""
    from torch_twins import env_name, pair, sub

    def scn(rt):
        monkeypatch.setenv(env_name(rt, "STORE_BACKEND"), backend)
        make = sub(rt, "_private.object_store").make_object_store
        xfer = sub(rt, "_private.object_transfer")
        tag = f"xfer{backend}{rt.__name__.replace('_', '')}"
        src, dst = make(tag + "src"), make(tag + "dst")
        srv = xfer.ObjectPlaneServer(src, host="127.0.0.1")
        try:
            payload = os.urandom(300_000)
            src.put_parts("aa11", [payload], len(payload))
            spilled = os.urandom(120_000)
            src.put_parts("bb22", [spilled], len(spilled))
            out = [src.spill("bb22")]  # the serve-from-spill path
            fetcher = xfer.ObjectFetcher(dst)
            out += [bool(fetcher.fetch("aa11", srv.address)),
                    bool(fetcher.fetch("bb22", srv.address)),
                    bytes(dst.get("aa11").buf) == payload,
                    bytes(dst.get("bb22").buf) == spilled,
                    fetcher.fetch("nope", srv.address)]  # the miss path
            if hasattr(src, "used"):  # arena: the send must not leak its pin
                src.delete("aa11")
                out.append(src.used())
            return out
        finally:
            srv.stop()
            src.cleanup_session()
            dst.cleanup_session()

    want = [True, True, True, True, True, False]
    pair(scn, want + [0] if backend == "arena" else want)
