"""Device collectives over the axes of the current mesh, the twin of
ray_tpu/parallel/collectives.py.

Each function takes an axis name (or a tuple of them, as ``lax.psum``
does) and runs on the process group of that axis of the mesh made current
by ``mesh.use_mesh``; with no mesh in use an axis name is unbound and the
call raises, as JAX raises outside shard_map. Every call is issued, even
over an axis of size 1: there is one code path, and the backend (NCCL on
CUDA tensors, gloo on CPU or CUDA tensors) is the only switch.

Autograd: every function is differentiable, and its backward is the
transpose of the linear map it computes when each rank's copy of a
replicated value is its own variable, the objective being the sum over
ranks (the convention of ``torch.distributed.nn`` and of shard_map without
replication typing): allreduce's transpose is an allreduce, allgather's a
reduce-scatter and back, ring_permute's the opposite shift, all_to_all's
the all_to_all with split and concat swapped. The train steps
(train/spmd.py) seed each rank's loss with 1/size and sum each gradient
over the axes its parameter is replicated on, which makes the result the
gradient of the global loss whichever collectives the model used.

All movement reduces to three torch.distributed calls, ``all_reduce``,
``all_gather`` and ``all_to_all_single`` (ring_permute and reducescatter
are uneven and even all-to-alls), which NCCL and gloo both take. ``calls``
counts the calls issued, forward and backward, by name.
"""

from __future__ import annotations

import collections

import torch

from ray_tpu_torch.parallel.mesh import (axis_group, axis_rank, axis_size_of,
                                         current_mesh)

calls: collections.Counter = collections.Counter()


def _mesh_for(axis_name):
    mesh = current_mesh()
    if mesh is None:
        raise NameError(f"unbound axis name {axis_name!r}: no mesh in use "
                        "(wrap the call in parallel.use_mesh(mesh))")
    names = axis_name if isinstance(axis_name, tuple) else (axis_name,)
    missing = [a for a in names if a not in mesh.mesh_dim_names]
    if missing:
        raise NameError(f"unbound axis name(s) {missing}: the mesh has "
                        f"{tuple(mesh.mesh_dim_names)}")
    order = [mesh.mesh_dim_names.index(a) for a in names]
    if order != sorted(order):
        # torch's groups order their ranks ascending, which is the mesh's
        # row-major order only when the axes are named in mesh order
        raise ValueError(f"name the axes {names} in mesh order "
                         f"{tuple(mesh.mesh_dim_names)}")
    return mesh


def _group(axis_name):
    return axis_group(_mesh_for(axis_name), axis_name)


def axis_size(axis_name) -> int:
    """Static size of a named mesh axis (or the product over a tuple)."""
    return axis_size_of(_mesh_for(axis_name), axis_name)


def axis_index(axis_name) -> int:
    """This rank's index along a named mesh axis (row-major over a
    tuple)."""
    return axis_rank(_mesh_for(axis_name), axis_name)


def pvary(x, axes):
    """The identity. In JAX it marks a replicated value as varying over
    `axes` for shard_map's replication (vma) typing, a JAX artifact: here
    each rank's copy is already its own tensor, and the train steps' final
    gradient sum over replicated axes does what its transpose does."""
    return x


def zeros_varying_like(shape, dtype, ref):
    """Zeros of `shape` on `ref`'s device (vma typing, as for pvary, is a
    JAX artifact)."""
    return torch.zeros(shape, dtype=dtype, device=ref.device)


# ------------------------------------------------------- the three movers

def _all_reduce(x, group, op=None):
    import torch.distributed as dist

    y = x.contiguous().clone()
    calls["all_reduce"] += 1
    dist.all_reduce(y, op=op or dist.ReduceOp.SUM, group=group)
    return y


def _all_gather(x, group, n: int):
    """[n, *x.shape]: every rank's x, in group-rank order."""
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    calls["all_gather"] += 1
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def _all_to_all(x, group, out_splits=None, in_splits=None, out_numel=None):
    """all_to_all_single over the flattened x. Equal splits by default;
    with splits, the output holds `out_numel` elements."""
    import torch.distributed as dist

    flat = x.contiguous().reshape(-1)
    out = torch.empty(flat.numel() if out_numel is None else out_numel,
                      dtype=flat.dtype, device=flat.device)
    calls["all_to_all"] += 1
    dist.all_to_all_single(out, flat, out_splits, in_splits, group=group)
    return out


# ------------------------------------------------------ autograd functions

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _gather_along(x, group, n, axis, tiled):
    parts = _all_gather(x, group, n)
    if not tiled:
        return parts.movedim(0, axis)
    return torch.cat(parts.unbind(0), dim=axis)


def _scatter_along(x, group, n, dim, tiled):
    """Sum over ranks of each rank's chunk `me` of x along dim."""
    if tiled:
        if x.shape[dim] % n:
            raise ValueError(f"reducescatter: dim {dim} of {tuple(x.shape)} "
                             f"not divisible by {n}")
        chunks = torch.stack(x.chunk(n, dim=dim))   # [n, ...chunk]
    else:
        if x.shape[dim] != n:
            raise ValueError(f"untiled reducescatter needs dim {dim} of "
                             f"size {n}, got {tuple(x.shape)}")
        chunks = x.movedim(dim, 0)
    got = _all_to_all(chunks, group).reshape(chunks.shape)
    return got.sum(0)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, axis, tiled):
        ctx.args = (group, n, axis, tiled)
        return _gather_along(x, group, n, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        group, n, axis, tiled = ctx.args
        return _scatter_along(g, group, n, axis, tiled), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim, tiled):
        ctx.args = (group, n, dim, tiled)
        return _scatter_along(x, group, n, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        group, n, dim, tiled = ctx.args
        return _gather_along(g, group, n, dim, tiled), None, None, None, None


def _permute(x, group, n, me, shift):
    """Send x to group rank (me + shift) % n, receive from (me - shift) % n."""
    numel = x.numel()
    ins = [0] * n
    outs = [0] * n
    ins[(me + shift) % n] = numel
    outs[(me - shift) % n] = numel
    return _all_to_all(x, group, outs, ins, numel).reshape(x.shape)


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, shift):
        ctx.args = (group, n, me, shift)
        return _permute(x, group, n, me, shift)

    @staticmethod
    def backward(ctx, g):
        group, n, me, shift = ctx.args
        return _permute(g, group, n, me, -shift), None, None, None, None


def _exchange(x, group, n, split_axis, concat_axis, tiled):
    if tiled:
        chunks = torch.stack(x.chunk(n, dim=split_axis))
    else:
        chunks = x.movedim(split_axis, 0)
    got = _all_to_all(chunks, group).reshape(chunks.shape)
    if tiled:
        return torch.cat(got.unbind(0), dim=concat_axis)
    return got.movedim(0, concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis, tiled):
        if tiled and x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of "
                             f"{tuple(x.shape)} not divisible by {n}")
        ctx.args = (group, n, split_axis, concat_axis, tiled)
        return _exchange(x, group, n, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        group, n, split_axis, concat_axis, tiled = ctx.args
        return (_exchange(g, group, n, concat_axis, split_axis, tiled),
                None, None, None, None, None)


# ---------------------------------------------------------- the public API

def allreduce(x, axis_name):
    return _AllReduce.apply(x, _group(axis_name))


def allreduce_mean(x, axis_name):
    return allreduce(x, axis_name) / axis_size(axis_name)


def allreduce_max(x, axis_name):
    """Elementwise max over the axis; not differentiable (used for
    stabilising shifts, whose gradient cancels)."""
    import torch.distributed as dist

    return _all_reduce(x.detach(), _group(axis_name), dist.ReduceOp.MAX)


def reducescatter(x, axis_name, *, scatter_dimension: int = 0,
                  tiled: bool = True):
    """Sum over the axis, each rank keeping its chunk of
    `scatter_dimension` (tiled; untiled: that dim has the axis' size and is
    dropped)."""
    return _ReduceScatter.apply(x, _group(axis_name), axis_size(axis_name),
                                scatter_dimension % x.dim(), tiled)


def allgather(x, axis_name, *, axis: int = 0, tiled: bool = True):
    """Every rank's x concatenated along `axis` (tiled), or stacked along a
    new `axis` (untiled), in axis-index order."""
    dim = axis % (x.dim() + (0 if tiled else 1))
    return _AllGather.apply(x, _group(axis_name), axis_size(axis_name), dim,
                            tiled)


def broadcast(x, axis_name, *, root: int = 0):
    """Every member gets root's value (select + allreduce keeps it one
    collective, as in the JAX package)."""
    # a where, not a Python branch: every rank keeps x in its graph, so the
    # backward's allreduce is issued on every rank
    is_root = torch.tensor(axis_index(axis_name) == root, device=x.device)
    return allreduce(torch.where(is_root, x, torch.zeros_like(x)), axis_name)


def scatter(x, axis_name, *, root: int = 0):
    """Axis index j gets root's x[j] (x: [axis size, ...] on root; on the
    other members x only gives the shape and dtype). One all_to_all_single
    in which only root sends. Not differentiable."""
    n, me = axis_size(axis_name), axis_index(axis_name)
    numel = x[0].numel()
    ins = [numel] * n if me == root else [0] * n
    outs = [0] * n
    outs[root] = numel
    src = x if me == root else x.new_empty((0,))
    return _all_to_all(src, _group(axis_name), outs, ins,
                       numel).reshape(x.shape[1:])


def ring_permute(x, axis_name, *, shift: int = 1):
    """Send x to axis index (i + shift) % n and receive from (i - shift) % n:
    one all_to_all_single with a single non-empty chunk each way."""
    return _RingPermute.apply(x, _group(axis_name), axis_size(axis_name),
                              axis_index(axis_name), shift)


def all_to_all(x, axis_name, *, split_axis: int, concat_axis: int,
               tiled: bool = True):
    """Split x along `split_axis` into axis-size chunks, send chunk j to
    axis index j, concatenate what arrives along `concat_axis` (untiled:
    `split_axis` has the axis' size and is consumed, the arrivals stack on
    a new `concat_axis`)."""
    return _AllToAll.apply(x, _group(axis_name), axis_size(axis_name),
                           split_axis % x.dim(), concat_axis % x.dim(), tiled)
