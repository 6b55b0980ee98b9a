"""ZeRO-1 sharded optimizer update over the dp axis: the rules plane and the
device plane of ray_tpu/train/zero.py.

Plain data parallelism replicates the optimizer state on every replica
(AdamW's two f32 moments are 8 bytes a parameter), and every replica does
the same update. ZeRO stage 1 (arXiv 2004.13336) shards the state and the
update: each replica owns 1/W of each parameter, updates only that shard
with only that shard's state, and the shards are gathered back into full
parameters.

- **Rules plane**: regex partition rules over '/'-joined leaf paths name
  each parameter's PartitionSpec (``match_partition_rules``), and the
  optimizer state additionally gets the dp axis folded into its first free
  divisible dimension (``zero_shard_spec``).
- **Device plane**: the meshed train step (train/spmd.py) with
  ``zero_axis``, and ``make_zero_train_step``: the gradient of a dp-folded
  leaf is reduce-scattered over dp, the optimizer updates this rank's
  contiguous shard (a separate tensor, so the state is never allocated at
  full size), and the updated shards are all-gathered back into the
  parameter. ``sharded_state_bytes`` is what this rank holds.

The host-collective plane (``ZeroShardedOptimizer``, the JAX package's
ZeRO-1 over its actor ring) stands on the port of ``util.collective`` and
the train session: ROADMAP.md Queue 1 item 12.
"""

from __future__ import annotations

import re
from typing import Callable, Sequence

import torch

from ray_tpu_torch.parallel.mesh import (MESH_AXIS_DP, MESH_AXIS_FSDP,
                                         NamedSharding, P, PartitionSpec,
                                         axis_rank, axis_size_of, spec_axes,
                                         tree_map)
from ray_tpu_torch.train.optim import optimizer_state_bytes, param_leaves

# ------------------------------------------------------------ rules plane


def tree_path_name(path) -> str:
    """'/'-joined name of a key path (the dict keys from the root), the
    string the regex rules match against."""
    return "/".join(str(k) for k in path)


def _with_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _leaf_spec(rules, path, leaf, strict: bool) -> PartitionSpec:
    shape = tuple(getattr(leaf, "shape", ()))
    n = 1
    for d in shape:
        n *= d
    if not shape or n == 1:
        return P()  # never partition scalars
    name = tree_path_name(path)
    for pat, spec in rules:
        if pat.search(name) is not None:
            return spec
    if strict:
        raise ValueError(f"no partition rule matches leaf {name!r} "
                         f"(shape {shape})")
    return P()


def match_partition_rules(rules: Sequence[tuple[str, PartitionSpec]], tree,
                          *, strict: bool = True):
    """Tree of PartitionSpec from regex rules over '/'-joined leaf paths.
    Works on params and on optimizer-state trees whose paths embed the
    param names (``optimizer_state_tree``: ``exp_avg/layers/wq`` still
    matches a ``layers/wq`` rule). Scalars and 1-element leaves are never
    partitioned. With strict=False an unmatched leaf falls back to
    replicated P() instead of raising."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    return _with_paths(lambda path, leaf: _leaf_spec(compiled, path, leaf,
                                                     strict), tree)


def optimizer_state_tree(optimizer: torch.optim.Optimizer, params) -> dict:
    """{state name: tree like `params` of that state} for the params the
    optimizer has state for, the counterpart of an optax state's paths
    (``mu/layers/wq``); a param without state (no step yet) is absent."""
    out: dict = {}

    def visit(path, p):
        for name, value in optimizer.state.get(p, {}).items():
            node = out.setdefault(name, {})
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = value

    _with_paths(visit, params)
    return out


def zero_shard_spec(spec, shape: Sequence[int], mesh,
                    axis: str = MESH_AXIS_DP) -> PartitionSpec:
    """Fold `axis` into the first dimension the spec leaves unsharded and
    whose size divides by the axis — the greedy ZeRO-1 placement. A leaf
    already sharded over `axis`, or with no divisible free dimension,
    keeps its spec (replicated over dp is the correct fallback). `mesh` is
    a DeviceMesh or a MeshSpec."""
    size = axis_size_of(mesh, axis)
    if size <= 1 or not shape or axis in spec_axes(spec):
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for i, dim in enumerate(shape):
        if entries[i] is None and dim % size == 0:
            entries[i] = axis
            return P(*entries)
    return spec


def fold_dim(spec, shape, mesh, axis: str = MESH_AXIS_DP) -> int | None:
    """The dim ``zero_shard_spec`` folds `axis` into, or None."""
    z = zero_shard_spec(spec, shape, mesh, axis)
    if z is spec:
        return None
    return next(i for i, e in enumerate(z)
                if e == axis and (i >= len(spec) or spec[i] is None))


def param_shardings_from_rules(rules, params, mesh):
    return tree_map(lambda s: NamedSharding(mesh, s),
                    match_partition_rules(rules, params),
                    is_leaf=lambda x: isinstance(x, PartitionSpec))


def zero_opt_shardings(optimizer, params, rules, mesh, *,
                       axis: str = MESH_AXIS_DP):
    """NamedSharding tree, like `params`, of each param's optimizer state
    with the ZeRO-1 dp folding applied on top of the regex rules. A torch
    optimizer keeps its state per param, at the param's shape (AdamW's
    moments, ``AdamWInt8``'s padded int8 blocks of it), so one sharding a
    param covers its whole state; `optimizer` is taken for the JAX
    signature and not consulted."""
    specs = match_partition_rules(rules, params)
    return tree_map(
        lambda s, p: NamedSharding(mesh, zero_shard_spec(
            s, tuple(p.shape), mesh, axis)),
        specs, params, is_leaf=lambda x: isinstance(x, PartitionSpec))


class ZeroOptState:
    """A ZeRO-1 optimizer state: the torch optimizer over this rank's
    update targets (the dp shard of each dp-folded leaf, the leaf itself
    otherwise), and each leaf's folded dim (None: not folded)."""

    def __init__(self, optimizer, targets: list, dims: list, axis: str):
        self.optimizer = optimizer
        self.targets = targets
        self.dims = dims
        self.axis = axis


def init_zero_opt_state(optimizer: Callable, params, specs, mesh,
                        axis: str = MESH_AXIS_DP) -> ZeroOptState:
    """Build `optimizer` (a factory: params tree → torch optimizer, e.g.
    ``functools.partial(train.adamw, learning_rate=1e-3)``) over this
    rank's update targets. `params` holds local shards under `specs`
    (trees of the same shape); the state is allocated at shard size, never
    at full size."""
    n = axis_size_of(mesh, axis)
    me = axis_rank(mesh, axis)
    leaves = param_leaves(params)
    spec_list = param_leaves(specs)
    targets, dims = [], []
    for p, spec in zip(leaves, spec_list):
        d = fold_dim(spec, tuple(p.shape), mesh, axis)
        if d is None:
            targets.append(p)
        else:
            c = p.shape[d] // n
            targets.append(p.detach().narrow(d, me * c, c).clone())
        dims.append(d)
    tree = _unflatten(params, targets)
    return ZeroOptState(optimizer(tree), targets, dims, axis)


def _unflatten(like, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def make_zero_train_step(loss_fn: Callable, params_template, mesh,
                         optimizer: Callable, rules, *,
                         batch_spec=P((MESH_AXIS_DP, MESH_AXIS_FSDP)),
                         axis: str = MESH_AXIS_DP, donate: bool = True):
    """ZeRO-1 over `axis`: returns (step, init_opt_state, shard_params,
    batch_sharding), as the JAX version. `params_template` is the full
    param tree (or a tree of anything with ``.shape``) the rules are
    matched against; `optimizer` is a factory (params tree → torch
    optimizer). ``init_opt_state(params)`` builds the state straight into
    its shards; ``step(params, opt_state, batch)`` is the meshed step of
    train/spmd.py with ``zero_axis=axis``."""
    from ray_tpu_torch.train.spmd import make_train_step

    step, shard_params, batch_sharding = make_train_step(
        loss_fn, optimizer, mesh=mesh, batch_spec=batch_spec, donate=donate,
        partition_rules=rules, params_template=params_template,
        zero_axis=axis)
    specs = match_partition_rules(rules, params_template)

    def init_opt_state(params):
        return init_zero_opt_state(optimizer, params, specs, mesh, axis)

    return step, init_opt_state, shard_params, batch_sharding


def sharded_state_bytes(opt_state) -> int:
    """Bytes of optimizer state this rank holds: under ZeRO-1 each folded
    leaf's state is its 1/W shard, so this drops ~W x against an unsharded
    optimizer (compare ``optim.optimizer_state_bytes`` of one)."""
    if isinstance(opt_state, ZeroOptState):
        opt_state = opt_state.optimizer
    return optimizer_state_bytes(opt_state)
