"""Serialization: cloudpickle + pickle-5 out-of-band buffers.

Layout of a serialized payload:

    [8-byte little-endian pickle length][pickle bytes]
    [8-byte n_buffers][for each buffer: 8-byte length][buffer bytes]

Out-of-band buffers let numpy arrays round-trip zero-copy when the payload is
mmap'd from the shared-memory object store (reference:
python/ray/_private/serialization.py + arrow_serialization.py do the same via
pickle protocol 5).

The port's copy of ray_tpu/_private/serialization.py. A ``torch.Tensor``
gets the treatment the JAX package gives a ``jax.Array`` (whose reduce
yields a numpy array): its host bytes go out of band as a uint8 numpy
array, so a CPU tensor read from the store is a zero-copy view tethered to
its store pin. dtype (bf16 too, through the uint8 view), shape and strides
survive. A CUDA tensor is copied to the host on the sending side and
restored onto the receiving process's card; a process with no card refuses
it (``DeviceUnavailableError``), it never silently becomes a CPU tensor.
The runtime never imports torch: the reducer engages only when the sending
process has already loaded it.
"""

from __future__ import annotations

import pickle
import struct
import sys
from typing import Any

import cloudpickle

_U64 = struct.Struct("<Q")


class DeviceUnavailableError(RuntimeError):
    """A CUDA tensor reached a process that sees no GPU."""


def _reduce_tensor(t):
    """(rebuild, args) for a strided CPU or CUDA tensor (or Parameter):
    the storage span its elements cover, as uint8 host bytes, plus dtype,
    shape and strides. None for anything else (torch's own reduce)."""
    torch = sys.modules["torch"]
    if (t.layout is not torch.strided or t.is_quantized
            or t.device.type not in ("cpu", "cuda")
            or type(t) not in (torch.Tensor, torch.nn.Parameter)):
        return None
    x = t.detach().resolve_conj().resolve_neg()
    shape, strides = tuple(x.shape), tuple(x.stride())
    # elements from the first to the last one the tensor addresses: a view
    # with gaps sends its span, an expanded (stride 0) one a single row
    span = 0 if x.numel() == 0 else 1 + sum(
        (n - 1) * st for n, st in zip(shape, strides))
    flat = x.as_strided((span,), (1,), x.storage_offset())
    if x.is_cuda:
        flat = flat.cpu()
    host = flat.view(torch.uint8).numpy() if span else None
    return _rebuild_tensor, (host, str(x.dtype).removeprefix("torch."),
                             shape, strides, x.is_cuda, t.requires_grad,
                             isinstance(t, torch.nn.Parameter))


def _rebuild_tensor(host, dtype, shape, strides, on_cuda, requires_grad,
                    is_param):
    import warnings

    import torch

    dt = getattr(torch, dtype)
    device = torch.device("cpu")
    if on_cuda:
        if not torch.cuda.is_available():
            raise DeviceUnavailableError(
                f"a CUDA tensor {list(shape)} {dtype} reached a process that "
                "sees no GPU: give the task or actor that receives it "
                "num_gpus=... (a CPU worker is hidden from the cards)")
        device = torch.device("cuda", torch.cuda.current_device())
    if host is None:
        t = torch.empty_strided(shape, strides, dtype=dt, device=device)
    else:
        with warnings.catch_warnings():
            # a read-only store mapping (the file backend): the tensor
            # aliases it exactly as numpy's zero-copy arrays do
            warnings.filterwarnings("ignore", message=".*not writable.*")
            raw = torch.from_numpy(host)
        if on_cuda:
            raw = raw.to(device)
        t = raw.view(dt).as_strided(shape, strides)
    if is_param:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


class _Pickler(cloudpickle.CloudPickler):
    """cloudpickle with the tensor reducer, engaged once torch is loaded."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            red = _reduce_tensor(obj)
            if red is not None:
                return red
        return super().reducer_override(obj)


def _pickle(obj: Any, buffer_callback) -> bytes:
    import io

    f = io.BytesIO()
    _Pickler(f, protocol=5, buffer_callback=buffer_callback).dump(obj)
    return f.getvalue()


def load_class_by_ref(module: str, qualname: str, search_path: str | None = None):
    """Import `module` and return the class named `qualname`, unwrapping an
    @remote ActorClass wrapper if the module attribute is one. `search_path`
    (the defining file's directory on the driver) is appended to sys.path as
    a fallback — workers may lack the driver script's sys.path[0]."""
    import importlib
    import sys

    from ray_tpu_torch.actor import ActorClass

    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError:
        if not search_path or search_path in sys.path:
            raise
        sys.path.append(search_path)
        mod = importlib.import_module(module)
    obj = getattr(mod, qualname)
    return obj.cls if isinstance(obj, ActorClass) else obj


class ClassByRef:
    """Pickles as an import reference; loads() yields the class itself.

    Used for actor classes that are importable on workers: @remote rebinds
    the module attribute to the ActorClass wrapper, which defeats
    cloudpickle's by-reference logic and forces by-value class pickling
    (fragile — class bodies referencing unpicklable module globals fail, and
    blobs are large). (reference: the function/actor export path registers
    importable code by reference too, _private/function_manager.py.)"""

    def __init__(self, module: str, qualname: str, search_path: str | None = None):
        self.module = module
        self.qualname = qualname
        self.search_path = search_path

    def __reduce__(self):
        return (load_class_by_ref, (self.module, self.qualname, self.search_path))


def class_ref_or_none(cls) -> "ClassByRef | None":
    """Return a ClassByRef if `cls` is reachable by import, else None."""
    import sys

    module = getattr(cls, "__module__", None)
    qualname = getattr(cls, "__qualname__", "")
    if not module or module == "__main__" or "." in qualname or "<locals>" in qualname:
        return None
    mod = sys.modules.get(module)
    if mod is None:
        return None
    try:
        if load_class_by_ref(module, qualname) is cls:
            import os

            src = getattr(mod, "__file__", None)
            return ClassByRef(module, qualname,
                              os.path.dirname(src) if src else None)
    except Exception:
        return None
    return None


def dumps(obj: Any) -> bytes:
    buffers: list[pickle.PickleBuffer] = []
    pick = _pickle(obj, buffers.append)
    parts = [_U64.pack(len(pick)), pick, _U64.pack(len(buffers))]
    for b in buffers:
        raw = b.raw()
        parts.append(_U64.pack(raw.nbytes))
        parts.append(raw)
    return b"".join(parts)


def dumps_into(obj: Any) -> tuple[list[bytes | memoryview], int]:
    """Like dumps but returns (parts, total_size) without joining — lets the
    object store write directly into shm without an extra copy."""
    buffers: list[pickle.PickleBuffer] = []
    pick = _pickle(obj, buffers.append)
    parts: list[bytes | memoryview] = [_U64.pack(len(pick)), pick, _U64.pack(len(buffers))]
    total = 8 + len(pick) + 8
    for b in buffers:
        raw = b.raw()
        parts.append(_U64.pack(raw.nbytes))
        parts.append(raw)
        total += 8 + raw.nbytes
    return parts, total


def _tethered(view: memoryview, owner: Any):
    """Wrap a zero-copy buffer slice so its consumers keep `owner` alive.

    Out-of-band buffers become the base of the numpy arrays pickle
    reconstructs; a plain memoryview keeps only the mmap alive, NOT the
    store pin wrapper — so freeing the ref would release the pin and let
    the arena recycle the slot under live views (plasma semantics: a Get
    buffer pins the entry, and deleting a pinned entry defers space reuse
    until the final release — csrc/shm_store.cc kDeleting). A ctypes array
    is the one pure-Python buffer exporter that reports ITSELF as the
    owner of derived memoryviews (numpy's export redirects to the root
    base, so an ndarray-subclass tether gets collapsed away)."""
    import ctypes

    try:
        t = (ctypes.c_char * view.nbytes).from_buffer(view)
    except (TypeError, ValueError):
        # read-only buffer: the file-backend PROT_READ mmap. Unlinked-file
        # pages persist while mapped, so there is no reuse hazard to pin
        # against — the plain view is safe there.
        return view
    t._tether_owner = owner
    return t


def loads(data: bytes | memoryview, owner: Any = None) -> Any:
    view = memoryview(data)
    (pick_len,) = _U64.unpack_from(view, 0)
    pick = view[8 : 8 + pick_len]
    off = 8 + pick_len
    (n_buf,) = _U64.unpack_from(view, off)
    off += 8
    buffers = []
    for _ in range(n_buf):
        (blen,) = _U64.unpack_from(view, off)
        off += 8
        b = view[off : off + blen]
        buffers.append(_tethered(b, owner) if owner is not None else b)
        off += blen
    return pickle.loads(pick, buffers=buffers)
