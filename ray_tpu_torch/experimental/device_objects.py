"""Device objects: tensors passed by reference between actors.

The port's copy of ray_tpu/experimental/device_objects.py (reference
capability: Ray Direct Transport / GPU objects,
python/ray/experimental/gpu_object_manager/gpu_object_manager.py:84 —
`@ray.method(tensor_transport="nccl")` keeps tensors in device memory and
passes them by reference through actor calls).

A per-process registry holds torch tensors by tensor id. A method declared
`@ray_tpu_torch.method(tensor_transport="device")` has its result's tensors
swapped for small markers before serialization: the bytes never leave the
card for the control plane. Every `torch.Tensor` leaf counts, CPU or CUDA.
Consumers:

- same process (self-calls, co-located consumers): the registry's tensor
  itself, no copy;
- other process: on-demand export. The owner is asked (through the GCS)
  to serialize that one tensor into the shared-memory object plane, and
  the consumer reads it from there. The port's serializer makes one
  device→host copy on the owner's side, keeps the dtype (bf16 too) and
  shape, and puts a CUDA tensor back onto the consumer's own card (a
  consumer that sees no card refuses it). The JAX package hands such a
  consumer a host numpy array instead.

Registry entries are owned by the actor that produced them: they are freed
when the cluster frees the enclosing object (the marker rides the normal
contained-refs channel), or explicitly via `free_device_tensors`. The
registry holds the producer's tensor and nothing else does once the task
returned, so freeing the object drops the last reference to its memory.
"""

from __future__ import annotations

import sys
import threading
import uuid
from typing import Any

_lock = threading.Lock()
_registry: dict[str, Any] = {}
# owner-side cache of host-staged exports: tensor_id -> pinned store oid
_exports: dict[str, str] = {}
# per-tensor in-flight export guard: two concurrent export requests must not
# both stage a device→host copy (the loser's pinned oid would leak)
_export_inflight: dict[str, threading.Lock] = {}
# unpickle-time detection: constructing a marker during ser.loads flips the
# active capture, so consumers restore exactly when needed (any nesting
# depth)
_capture = threading.local()


class marker_capture:
    """Context manager: `with marker_capture() as saw: ...; saw()` is True
    iff a DeviceTensorMarker was constructed inside the block (valid after
    the block exits too)."""

    def __enter__(self):
        self._prev = getattr(_capture, "seen", None)
        self._result = False
        _capture.seen = False
        return lambda: self._result or bool(getattr(_capture, "seen", False))

    def __exit__(self, *exc):
        self._result = bool(getattr(_capture, "seen", False))
        _capture.seen = self._prev
        return False


class DeviceTensorMarker:
    """Placeholder serialized in place of a registered tensor."""

    __slots__ = ("tensor_id", "owner_wid", "shape", "dtype")

    def __init__(self, tensor_id: str, owner_wid: str, shape, dtype):
        self.tensor_id = tensor_id
        self.owner_wid = owner_wid
        self.shape = shape
        self.dtype = dtype
        if getattr(_capture, "seen", None) is False:
            _capture.seen = True

    def __repr__(self):
        return (f"DeviceTensorMarker({self.tensor_id[:8]}…, "
                f"shape={self.shape}, dtype={self.dtype})")

    def __reduce__(self):
        return (DeviceTensorMarker,
                (self.tensor_id, self.owner_wid, self.shape, str(self.dtype)))


def _is_device_array(x) -> bool:
    # the runtime never imports torch: a process that has not loaded it
    # holds no tensor to register
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _tree_map(fn, tree, is_leaf):
    """`fn` over the leaves of nested dicts, lists, tuples and namedtuples
    (the containers jax.tree_util walks in the reference); every other
    object is a leaf, and the containers are rebuilt with their own type."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        out = {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
        return out if type(tree) is dict else type(tree)(out)
    if _is_namedtuple(tree):
        return type(tree)(*(_tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def extract(value: Any, owner_wid: str) -> "tuple[Any, list[str]]":
    """Replace every tensor leaf in `value` with a marker, registering the
    tensor in this process's registry. Returns (value, tensor_ids) so the
    producer can tie registry lifetime to the enclosing object."""
    tids: list[str] = []

    def swap(leaf):
        if _is_device_array(leaf):
            tid = uuid.uuid4().hex
            with _lock:
                _registry[tid] = leaf
            tids.append(tid)
            return DeviceTensorMarker(
                tid, owner_wid, tuple(leaf.shape),
                str(leaf.dtype).removeprefix("torch."))
        return leaf

    return _tree_map(swap, value, _is_device_array), tids


def restore(value: Any, worker) -> Any:
    """Resolve markers: registry hit in-process, host-staged export pull
    across processes."""

    def is_marker(x):
        return isinstance(x, DeviceTensorMarker)

    def unswap(leaf):
        if not is_marker(leaf):
            return leaf
        with _lock:
            t = _registry.get(leaf.tensor_id)
        if t is not None:
            return t  # no copy: this process owns the tensor
        return _fetch_remote(leaf, worker)

    return _tree_map(unswap, value, is_marker)


def _fetch_remote(marker: DeviceTensorMarker, worker):
    """Ask the owner (through the GCS) to export the tensor into the object
    plane, then read it locally (reference: RDT transport fallback path)."""
    reply = worker.rpc({"type": "export_tensor",
                        "tensor_id": marker.tensor_id,
                        "owner_wid": marker.owner_wid}, timeout=120.0)
    if not reply.get("ok"):
        raise RuntimeError(
            f"device tensor {marker.tensor_id[:8]}… unavailable: "
            f"{reply.get('error')}")
    return worker.get_object(reply["oid"], timeout=120.0)


def export_to_store(tensor_id: str, worker) -> str | None:
    """Owner-side: serialize one registered tensor into the object store
    and register it with the GCS; returns the oid (None if unknown). The
    port's serializer stages it: one device→host copy, dtype kept."""
    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch._private.ids import ObjectID

    with _lock:
        cached = _exports.get(tensor_id)
        if cached is not None:
            return cached  # each tensor is host-staged at most once
        if tensor_id not in _registry:
            return None
        guard = _export_inflight.setdefault(tensor_id, threading.Lock())
    with guard:
        with _lock:  # the race loser re-checks under the guard
            cached = _exports.get(tensor_id)
            t = _registry.get(tensor_id)
        if cached is not None:
            return cached
        if t is None:
            return None  # freed while we waited
        oid = ObjectID.for_put().hex()
        parts, total = ser.dumps_into(t)
        tier = worker.store.put_parts(oid, parts, total)
        worker.send_no_reply({"type": "object_put", "oid": oid, "where": "shm",
                              "size": total, "host": worker.host_id,
                              "tier": tier, "pin": True})
        with _lock:
            if tensor_id not in _registry:
                freed = True  # freed mid-copy: our staged oid must not leak
            else:
                freed = False
                _exports[tensor_id] = oid
                _export_inflight.pop(tensor_id, None)
        if freed:
            try:
                worker.send_no_reply({"type": "free_objects_async",
                                      "oids": [oid]})
            except Exception:
                pass
            return None
        return oid


def free_device_tensors(tensor_ids, worker=None) -> None:
    """Drop registry entries (owner process); with `worker` given, also
    free the host-staged export copies cluster-wide."""
    stale_oids = []
    with _lock:
        for tid in tensor_ids:
            _registry.pop(tid, None)
            _export_inflight.pop(tid, None)
            oid = _exports.pop(tid, None)
            if oid:
                stale_oids.append(oid)
    if worker is not None and stale_oids:
        try:
            worker.send_no_reply({"type": "free_objects_async",
                                  "oids": stale_oids})
        except Exception:
            pass


def registry_size() -> int:
    with _lock:
        return len(_registry)
