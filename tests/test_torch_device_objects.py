"""Twins of tests/test_device_objects.py: tensors passed by reference
between actors, in each package.

Each scenario runs through ``ray_tpu`` (jax.Arrays) and ``ray_tpu_torch``
(torch tensors; every tensor leaf is a device object, CPU or CUDA) on one
module-scoped session each, and the two sides agree. The scenarios define
their actor classes inside themselves and kill what they made, so the
shared session keeps no worker pinned. Port-only tests pin where the port
differs on purpose: a consumer in another process gets a torch tensor of
the produced dtype (the JAX package hands it a host numpy array), a bf16
tensor flagged CUDA is staged through the port's serializer and lands on
the consumer's card (or is refused where there is none), the alias "tpu"
is refused, and the registry holds the producer's tensor itself.
``test_device_object_across_follower_hosts`` needs a second host: its twin
is in tests/test_torch_multihost.py.
"""

from __future__ import annotations

import gc
import os
import time
from functools import partial

import numpy as np
import pytest

from torch_twins import (is_port, pair, shutdown_runtimes, start_sessions,
                         sub, twin)

_twin = partial(twin, serve_cleanup=False)


@pytest.fixture(scope="module")
def pkgs():
    out = start_sessions(num_cpus=4, num_workers=2, max_workers=10)
    yield out
    shutdown_runtimes(out)


def _same(pkgs, scenario, want=None):
    a, b = _twin(pkgs, scenario)
    assert a == b, (a, b)
    if want is not None:
        assert a == want, a
    return a


def _kill(rt, *actors):
    for a in actors:
        try:
            rt.kill(a)
        except Exception:  # noqa: BLE001 — already dead
            pass


def _wait_registry(rt, actor, pred, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        n = rt.get(actor.registry_size.remote(), timeout=60)
        if pred(n):
            return n
        time.sleep(0.2)
    return rt.get(actor.registry_size.remote(), timeout=60)


# ------------------------------------------------------ test_device_objects


def _scn_roundtrip_local(rt):
    dev = sub(rt, "experimental.device_objects")
    if is_port(rt):
        import torch

        arr = torch.arange(16.0)
    else:
        import jax.numpy as jnp

        arr = jnp.arange(16.0)
    payload = {"w": arr, "meta": "keep", "nested": [arr * 2, 3]}
    out, tids = dev.extract(payload, "me")
    m = out["w"]
    back = dev.restore(out, worker=None)  # same process: registry hit
    got = (len(tids), out["meta"], type(m).__name__, m.shape,
           back["w"] is arr, float(back["nested"][0][1]),
           back["nested"][1])
    dev.free_device_tensors([m.tensor_id, out["nested"][0].tensor_id])
    return got + (dev.registry_size(),)


def test_marker_extract_restore_roundtrip_local():
    pair(_scn_roundtrip_local,
         (2, "keep", "DeviceTensorMarker", (16,), True, 2.0, 3, 0))


def _scn_self_call_zero_copy(rt):
    port = is_port(rt)

    @rt.remote
    class Holder:
        @rt.method(tensor_transport="device")
        def make(self, n):
            if port:
                import torch

                return {"x": torch.ones((n,)) * 3.0}
            import jax.numpy as jnp

            return {"x": jnp.ones((n,)) * 3.0}

        def consume(self, payload):
            # the marker resolves in-process from the registry
            return float(payload["x"].sum())

    h = Holder.remote()
    try:
        ref = h.make.remote(8)
        # the driver ships the REF onward without materializing the tensor
        return rt.get(h.consume.remote(ref), timeout=60)
    finally:
        _kill(rt, h)


def test_self_call_zero_copy(pkgs):
    _same(pkgs, _scn_self_call_zero_copy, 24.0)


def _scn_cross_process_export(rt):
    port = is_port(rt)

    @rt.remote
    class Producer:
        @rt.method(tensor_transport="device")
        def make(self):
            if port:
                import torch

                return torch.arange(32.0)
            import jax.numpy as jnp

            return jnp.arange(32.0)

    @rt.remote
    class Consumer:
        def total(self, arr):
            return float(arr.sum())

    p, c = Producer.remote(), Consumer.remote()
    try:
        ref = p.make.remote()
        # the consumer is ANOTHER process: resolves via host-staged export
        total = rt.get(c.total.remote(ref), timeout=60)
        arr = rt.get(ref, timeout=60)  # the driver can materialize it too
        return total, tuple(arr.shape)
    finally:
        _kill(rt, p, c)


def test_cross_process_fallback_export(pkgs):
    _same(pkgs, _scn_cross_process_export,
          (float(np.arange(32.0).sum()), (32,)))


def _scn_dead_owner(rt):
    import re

    port = is_port(rt)

    @rt.remote
    class P:
        @rt.method(tensor_transport="device")
        def make(self):
            if port:
                import torch

                return torch.ones((4,))
            import jax.numpy as jnp

            return jnp.ones((4,))

        def pid(self):
            return os.getpid()

    p = P.options(max_restarts=0).remote()
    ref = p.make.remote()
    pid = rt.get(p.pid.remote(), timeout=60)
    # the marker is produced before the kill, but NOT yet fetched
    os.kill(pid, 9)
    time.sleep(1.0)
    try:
        rt.get(ref, timeout=30)
    except Exception as e:  # noqa: BLE001 — the message is the result
        return bool(re.search("owner|unavailable|gone", str(e)))
    return "no error"


def test_dead_owner_raises(pkgs):
    _same(pkgs, _scn_dead_owner, True)


def _scn_registry_freed(rt):
    port = is_port(rt)
    dev_mod = f"{rt.__name__}.experimental.device_objects"

    @rt.remote
    class P:
        @rt.method(tensor_transport="device")
        def make(self):
            if port:
                import torch

                return torch.ones((128,))
            import jax.numpy as jnp

            return jnp.ones((128,))

        def registry_size(self):
            import importlib

            return importlib.import_module(dev_mod).registry_size()

    p = P.remote()
    try:
        ref = p.make.remote()
        rt.wait([ref], num_returns=1, timeout=60)
        before = rt.get(p.registry_size.remote(), timeout=60) >= 1
        del ref
        gc.collect()
        return before, _wait_registry(rt, p, lambda n: n == 0)
    finally:
        _kill(rt, p)


def test_registry_freed_with_enclosing_object(pkgs):
    """Dropping every ref to the marker-carrying object frees the owner's
    registry entries (reference: RDT lifetime tied to ObjectRef)."""
    _same(pkgs, _scn_registry_freed, (True, 0))


def _scn_per_result_partition(rt):
    port = is_port(rt)
    dev_mod = f"{rt.__name__}.experimental.device_objects"

    @rt.remote
    class P2:
        @rt.method(tensor_transport="device")
        def make_pair(self):
            if port:
                import torch

                return torch.ones((64,)) * 2.0, torch.ones((64,)) * 5.0
            import jax.numpy as jnp

            return jnp.ones((64,)) * 2.0, jnp.ones((64,)) * 5.0

        def consume(self, payload):
            return float(payload.sum())

        def registry_size(self):
            import importlib

            return importlib.import_module(dev_mod).registry_size()

    p = P2.remote()
    try:
        r0, r1 = p.make_pair.options(num_returns=2).remote()
        rt.wait([r0, r1], num_returns=2, timeout=60)
        s0 = rt.get(p.registry_size.remote(), timeout=60)
        del r0
        gc.collect()
        # r0's tensor goes, and r1's MUST survive it (a flat per-task list
        # freed both tensors when either object died)
        s1 = _wait_registry(rt, p, lambda n: n < s0)
        return s0 >= 2, s1 < s0, rt.get(p.consume.remote(r1), timeout=60)
    finally:
        _kill(rt, p)


def test_per_result_registry_partition(pkgs):
    """num_returns=2 with tensor transport: freeing return 0 keeps return
    1's registry entry live."""
    _same(pkgs, _scn_per_result_partition, (True, True, 64 * 5.0))


# ------------------------------------------------------------ port only


def _scn_consumer_type(rt):
    port = is_port(rt)

    @rt.remote
    class Producer:
        @rt.method(tensor_transport="device")
        def make(self):
            if port:
                import torch

                return torch.arange(12.0).to(torch.bfloat16).reshape(3, 4)
            import jax.numpy as jnp

            return jnp.arange(12.0).astype(jnp.bfloat16).reshape(3, 4)

    @rt.remote
    class Consumer:
        def describe(self, arr):
            return (type(arr).__module__.split(".")[0], type(arr).__name__,
                    str(arr.dtype), tuple(arr.shape),
                    [float(v) for v in arr.reshape(-1).tolist()])

    p, c = Producer.remote(), Consumer.remote()
    try:
        return rt.get(c.describe.remote(p.make.remote()), timeout=60)
    finally:
        _kill(rt, p, c)


def test_port_consumer_gets_a_torch_tensor_where_the_reference_gives_numpy(
        pkgs):
    """The consumer in another process gets a torch tensor of the produced
    dtype and shape; the JAX package's gets a host numpy array (its export
    stages through np.asarray)."""
    ref, port = _twin(pkgs, _scn_consumer_type)
    vals = [float(v) for v in range(12)]
    assert ref[:2] == ("numpy", "ndarray") and ref[3:] == ((3, 4), vals)
    assert port == ("torch", "Tensor", "torch.bfloat16", (3, 4), vals)


class _FakeWorker:
    """The two things export_to_store asks of its worker: a store to put
    the staged parts in, and the GCS message that registers them."""

    host_id = "host-0"

    def __init__(self):
        self.puts, self.sent = [], []
        self.store = self

    def put_parts(self, oid, parts, total):
        self.puts.append((oid, b"".join(bytes(p) for p in parts), total))
        return "shm"

    def send_no_reply(self, msg):
        self.sent.append(msg)


def test_port_bf16_cuda_flagged_export(monkeypatch):
    """A registered bf16 tensor flagged CUDA is staged once through the
    port's serializer (dtype and bytes kept, not through numpy), registered
    pinned with the GCS, and lands on the consumer's card; a consumer that
    sees no card refuses it instead of handing back a CPU tensor."""
    import torch

    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch.experimental import device_objects as dev

    real_reduce = ser._reduce_tensor

    def as_cuda(t):  # the reduce of the same tensor on a card
        fn, args = real_reduce(t)
        return fn, args[:4] + (True,) + args[5:]

    monkeypatch.setattr(ser, "_reduce_tensor", as_cuda)
    t = (torch.arange(24, dtype=torch.float32) / 7).to(torch.bfloat16)
    out, tids = dev.extract({"k": t}, "owner")
    w = _FakeWorker()
    try:
        oid = dev.export_to_store(tids[0], w)
        assert dev.export_to_store(tids[0], w) == oid  # staged at most once
        assert len(w.puts) == 1 and w.puts[0][0] == oid
        assert w.sent == [{"type": "object_put", "oid": oid, "where": "shm",
                           "size": w.puts[0][2], "host": "host-0",
                           "tier": "shm", "pin": True}]
        blob = w.puts[0][1]
        with pytest.raises(ser.DeviceUnavailableError):
            ser.loads(blob)  # this process sees no card
        devices = []
        real_device = torch.device

        def device(kind, *a):
            devices.append(kind)
            return real_device("cpu")

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch, "device", device)
        got = ser.loads(blob)
        assert devices[-1] == "cuda"  # put on the consumer's own card
        assert got.dtype is torch.bfloat16 and got.shape == t.shape
        assert torch.equal(got.view(torch.int16), t.view(torch.int16))
    finally:
        dev.free_device_tensors(tids)
    assert dev.registry_size() == 0
    assert out["k"].dtype == "bfloat16"


def test_port_refuses_the_tpu_alias():
    """The JAX package takes "tpu" as an alias of "device"; the port
    refuses it with the reference's ValueError, naming "device"."""
    import ray_tpu
    import ray_tpu_torch

    def f(self):
        return 1

    assert ray_tpu.method(tensor_transport="tpu")(f) is f
    with pytest.raises(ValueError, match="'device'"):
        ray_tpu_torch.method(tensor_transport="tpu")(f)


def test_port_registry_holds_the_producers_tensor(pkgs):
    """The registry keeps the returned tensor itself (a self-call sees the
    same storage), and freeing the enclosing object drops its last
    reference: nothing else in the producer holds it."""
    rt = pkgs[1]

    @rt.remote
    class P:
        @rt.method(tensor_transport="device")
        def make(self):
            import weakref

            import torch

            t = torch.ones((256,))
            self.ptr, self.alive = t.data_ptr(), weakref.ref(t)
            return {"t": t}

        def same_storage(self, payload):
            return payload["t"].data_ptr() == self.ptr

        def released(self):
            import gc

            gc.collect()
            return self.alive() is None

    p = P.remote()
    try:
        ref = p.make.remote()
        assert rt.get(p.same_storage.remote(ref), timeout=60) is True
        assert rt.get(p.released.remote(), timeout=60) is False
        del ref
        gc.collect()
        deadline = time.time() + 15
        while (time.time() < deadline
               and not rt.get(p.released.remote(), timeout=60)):
            time.sleep(0.2)
        assert rt.get(p.released.remote(), timeout=60) is True
    finally:
        _kill(rt, p)
