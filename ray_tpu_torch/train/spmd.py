"""Train-step builders: loss in, optimizer step out, on one device or over
a mesh. The twin of ray_tpu/train/spmd.py.

- ``make_train_step(loss_fn, optimizer)``: one device. The step runs
  eagerly, ``loss.backward()`` fills the leaves' ``.grad`` and the
  optimizer updates the leaves in place.
- ``make_train_step(loss_fn, optimizer, mesh=..., logical_axes=...)``: the
  counterpart of the JAX package's gspmd mode, written out. Each rank holds
  its shards under the rule tables (parallel/mesh.py DEFAULT_RULES, or
  regex ``partition_rules``) and its slice of the batch (``batch_spec``:
  rows over dp x fsdp). Leaves sharded over an axis the model does not
  split itself (fsdp's "embed", ZeRO-3) are all-gathered before use, so
  their gradients come back reduce-scattered; tp and ep shards go to the
  model as they are (its blocks split heads, mlp, vocab and experts by
  shape: models/transformer.py).
- ``make_sp_pp_train_step``: the counterpart of the manual (shard_map)
  mode: the user's per-shard loss runs on the local shards as given, with
  ring attention over sp and GPipe over pp inside it.

Gradients, both meshed steps: every rank seeds its local loss with
1/(mesh size), the collectives' backward are their transposes
(parallel/collectives.py), and each leaf's gradient is then summed over
every mesh axis its spec does not name (the axes it is replicated on). The
result is the gradient of the mean over ranks of the per-rank losses (the
global loss), whichever collectives the model used, with no replication
typing: a replicated leaf gets the sum of its copies' gradients, once.
The returned loss is the mean over the data axes.

``zero_axis`` (ZeRO-1, train/zero.py): the gradient of a leaf with a dp
dim folded in is reduce-scattered over dp instead, the optimizer updates
this rank's shard, and the shards are all-gathered back.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import (MESH_AXIS_DP, MESH_AXIS_EP,
                                         MESH_AXIS_FSDP, MESH_AXIS_TP,
                                         NamedSharding, P, PartitionSpec,
                                         axis_size_of, entry_axes,
                                         param_specs, spec_axes, tree_map,
                                         use_mesh)
from ray_tpu_torch.train.optim import param_leaves

# axes whose shards the model blocks take as they are
_MODEL_AXES = frozenset((MESH_AXIS_TP, MESH_AXIS_EP))


def _check_mesh(mesh):
    import torch.distributed as dist

    if not hasattr(mesh, "mesh_dim_names") or not hasattr(mesh, "get_group"):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(parallel.MeshSpec(...).build()), got {mesh!r}")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("the mesh's process group is not initialised "
                           "(start the ranks with parallel.launch)")


def _replicated_axes(mesh, spec) -> tuple:
    """The mesh axes a leaf with `spec` is replicated on, in mesh order."""
    named = spec_axes(spec)
    return tuple(a for a in mesh.mesh_dim_names if a not in named)


def _gather_for_use(p, spec, mesh):
    """The leaf as the model uses it: gathered (differentiably) over every
    axis of its spec the model does not split itself."""
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        gathered = tuple(a for a in axes if a not in _MODEL_AXES)
        if gathered and gathered != axes:
            raise ValueError(f"spec entry {entry} mixes model and data axes "
                             "on one dim")
        if gathered and axis_size_of(mesh, gathered) > 1:
            p = collectives.allgather(p, gathered, axis=dim)
    return p


def _reduce_grads(leaves, specs, mesh, zero=None):
    """Sum each leaf's gradient over the axes it is replicated on (one
    allreduce a leaf, issued even over axes of size 1); a ZeRO-folded leaf
    reduce-scatters over the zero axis instead and hands its shard's
    gradient to the optimizer's target."""
    for i, (p, spec) in enumerate(zip(leaves, specs)):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        axes = _replicated_axes(mesh, spec)
        d = None if zero is None else zero.dims[i]
        if d is not None:
            axes = tuple(a for a in axes if a != zero.axis)
            g = collectives.reducescatter(g, zero.axis, scatter_dimension=d)
        if axes:
            g = collectives.allreduce(g, axes if len(axes) > 1 else axes[0])
        if d is None:
            p.grad = g
        else:
            p.grad = None
            zero.targets[i].grad = g


def _gather_updates(leaves, zero):
    """ZeRO-1: every rank's updated shard back into the full leaf."""
    with torch.no_grad():
        for p, target, d in zip(leaves, zero.targets, zero.dims):
            if d is not None:
                p.copy_(collectives.allgather(target.detach(), zero.axis,
                                              axis=d))


def _meshed_step(loss_fn, mesh, specs, optimizer, *, gather: bool,
                 batch_axes=(), zero_axis=None, loss_axes=None):
    loss_axes = tuple(a for a in mesh.mesh_dim_names
                      if loss_axes is None or a in loss_axes)

    def step(params, opt_state, batch):
        from ray_tpu_torch.train import zero as zero_mod

        leaves = param_leaves(params)
        spec_list = param_leaves(specs)
        n = math.prod(mesh.mesh.shape)
        with use_mesh(mesh, batch_axes=batch_axes):
            if zero_axis is not None and opt_state is None:
                opt_state = zero_mod.init_zero_opt_state(
                    optimizer, params, specs, mesh, zero_axis)
            zero = opt_state if isinstance(opt_state,
                                           zero_mod.ZeroOptState) else None
            opt = zero.optimizer if zero is not None else (
                opt_state if isinstance(opt_state, torch.optim.Optimizer)
                else optimizer)
            if not isinstance(opt, torch.optim.Optimizer):
                raise TypeError("pass the torch optimizer over the local "
                                "shards as opt_state (e.g. optimizer(params)"
                                " for a factory)")
            opt.zero_grad(set_to_none=True)
            for p in leaves:  # ZeRO's optimizer holds shards, not leaves
                p.requires_grad_(True)
                p.grad = None
            if gather:
                params_in = tree_map(
                    lambda p, s: _gather_for_use(p, s, mesh), params, specs,
                    is_leaf=lambda x: isinstance(x, PartitionSpec))
            else:
                params_in = params
            loss = loss_fn(params_in, batch)
            (loss / n).backward()
            _reduce_grads(leaves, spec_list, mesh, zero)
            opt.step()
            if zero is not None:
                _gather_updates(leaves, zero)
            mean = collectives.allreduce_mean(loss.detach(), loss_axes)
        return params, opt_state, mean

    return step


def make_train_step(loss_fn: Callable, optimizer=None, *, mesh=None,
                    logical_axes=None,
                    batch_spec=P((MESH_AXIS_DP, MESH_AXIS_FSDP)),
                    donate: bool = True, partition_rules=None,
                    params_template=None, zero_axis: str | None = None):
    """``loss_fn(params, batch) -> scalar``.

    Without a mesh: returns ``step(params, opt_state, batch) -> (params,
    opt_state, loss)``. The step frees the previous gradients, runs forward
    and backward, and steps `optimizer` (built over the leaves of
    `params`, e.g. by ``train.adamw``), so params and optimizer state are
    updated in place and returned as they came; ``opt_state`` is carried
    only to keep the JAX signature. The loss comes back as a detached
    device scalar (no host sync).

    With `mesh` (a DeviceMesh over an initialised process group): returns
    ``(step, shard_params, batch_sharding)`` as the JAX version. Name the
    leaves' shardings by `logical_axes` (a tree of logical-dimension
    tuples, DEFAULT_RULES) or by `partition_rules` ([(regex,
    PartitionSpec)] over '/'-joined leaf paths) + `params_template` (the
    full params, or a tree of anything with ``.shape``).
    ``shard_params(full)`` cuts each rank's shards out of the full tree;
    ``batch_sharding.shard(batch)`` its rows of a full batch. `optimizer`
    is a factory (params tree → torch optimizer, e.g.
    ``functools.partial(train.adamw, learning_rate=1e-3)``) or an
    optimizer over the local shards; the step steps ``opt_state`` when it
    is a torch optimizer (``opt_state = optimizer(params)``), else
    `optimizer`. With `zero_axis` (needs the rules form) the optimizer
    state is ZeRO-1-sharded over that axis: pass ``opt_state=None`` on the
    first call (the step builds it at shard size from the factory) or
    ``zero.make_zero_train_step``'s ``init_opt_state(params)``. `donate` is
    kept for the JAX signature: the step always updates in place."""
    if mesh is None:
        if zero_axis is not None or logical_axes is not None \
                or partition_rules is not None:
            raise ValueError("logical_axes, partition_rules and zero_axis "
                             "need a mesh")

        def step(params, opt_state, batch):
            optimizer.zero_grad(set_to_none=True)
            loss = loss_fn(params, batch)
            loss.backward()
            optimizer.step()
            return params, opt_state, loss.detach()

        return step
    _check_mesh(mesh)
    if partition_rules is not None:
        if params_template is None:
            raise ValueError("partition_rules needs params_template "
                             "(a params tree or a tree of its shapes)")
        from ray_tpu_torch.train import zero as zero_mod

        specs = zero_mod.match_partition_rules(partition_rules,
                                               params_template)
    else:
        if zero_axis is not None:
            raise ValueError(
                "zero_axis needs partition_rules + params_template: the "
                "optimizer-state shardings are derived from the rules")
        if logical_axes is None:
            raise ValueError("a meshed step needs logical_axes or "
                             "partition_rules + params_template")
        specs = param_specs(logical_axes)
    if zero_axis is not None and not callable(optimizer):
        raise ValueError("zero_axis needs `optimizer` as a factory (params "
                         "tree → torch optimizer): the state is built over "
                         "the ZeRO shards")
    batch_spec = P(*batch_spec)
    # a MoE layer routes the global batch: the axes its rows are split over
    batch_axes = entry_axes(batch_spec[0]) if batch_spec else ()
    step = _meshed_step(loss_fn, mesh, specs, optimizer, gather=True,
                        batch_axes=batch_axes, zero_axis=zero_axis)

    def shard_params(params):
        return tree_map(lambda p, s: NamedSharding(mesh, s).shard(p).detach(),
                        params, specs,
                        is_leaf=lambda x: isinstance(x, PartitionSpec))

    return step, shard_params, NamedSharding(mesh, batch_spec)


def init_sharded(init_fn: Callable, logical_axes, mesh, *args,
                 partition_rules=None):
    """This rank's shards of ``init_fn(*args)``: every rank draws the full
    tree from the same seeded generator and keeps its shard (so the shards
    equal the unsharded init's, bit for bit). `partition_rules`
    ([(regex, PartitionSpec)]) replaces `logical_axes` when given."""
    _check_mesh(mesh)
    full = init_fn(*args)
    if partition_rules is not None:
        from ray_tpu_torch.train import zero as zero_mod

        specs = zero_mod.match_partition_rules(partition_rules, full)
    else:
        specs = param_specs(logical_axes)
    return tree_map(lambda p, s: NamedSharding(mesh, s).shard(p),
                    full, specs,
                    is_leaf=lambda x: isinstance(x, PartitionSpec))


def make_sp_pp_train_step(shard_loss_fn: Callable, param_specs, mesh,
                          optimizer, *, batch_spec,
                          loss_axes: tuple[str, ...]):
    """Manual-mode step: ``step(params, opt_state, batch) -> (params,
    opt_state, loss)`` on this rank's shards (params under `param_specs`,
    the batch under `batch_spec`, each cut with
    ``parallel.sharding_for(mesh, spec).shard``). ``shard_loss_fn(params,
    batch)`` runs on them as given, under the mesh. The loss returned is
    the per-shard loss averaged over `loss_axes`. Each gradient is summed
    over the axes its param is replicated on: the loss axes absent from
    its spec (stage-stacked layers on 'pp' keep per-shard gradients), as
    in the JAX package, and any other axis of size > 1 the same way, which
    is the transpose-correct rule without replication typing (see the
    module docstring). `optimizer` as in make_train_step."""
    _check_mesh(mesh)
    return _meshed_step(shard_loss_fn, mesh, param_specs, optimizer,
                        gather=False, loss_axes=loss_axes)
