"""Device mesh and sharding vocabulary, the twin of ray_tpu/parallel/mesh.py.

Every strategy is a named dimension of one
``torch.distributed.device_mesh.DeviceMesh`` whose dimension names are the
JAX package's six axes, in its order (outermost to innermost):

  dp    data parallel (gradient allreduce)
  fsdp  fully-sharded data parallel (params sharded, batch also split here)
  ep    expert parallel (MoE experts)
  pp    pipeline parallel (layer stages)
  sp    sequence/context parallel (ring attention)
  tp    tensor parallel (heads / mlp / vocab)

The port is explicit per-rank SPMD, the counterpart of ``shard_map``: each
rank holds the local shards its specs give it, and the collectives are
explicit calls on the process group of a named mesh dimension
(parallel/collectives.py). Where the JAX package lets XLA insert the
collectives from NamedShardings (its gspmd mode), the port's train step and
model blocks issue them from the same rule tables. Two reasons: the
hand-written kernels are ctypes launches with no DTensor sharding rules,
and the tensor-parallel engine needs the same rank-local blocks as the
tensor-parallel train step.

``use_mesh(mesh)`` makes a mesh current for the calling thread, as the body
of a ``shard_map`` binds its axis names: collectives resolve an axis name
against it, and the model blocks read the tensor- and expert-parallel
degrees from it. ``NamedSharding(mesh, spec)`` cuts a full tensor to this
rank's shard (``shard``) and gathers a shard back (``gather``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Mapping, Sequence

import torch

# the six axis names, copied from ray_tpu/_private/constants.py
MESH_AXIS_DP = "dp"        # data parallel (gradient allreduce)
MESH_AXIS_FSDP = "fsdp"    # fully-sharded data parallel
MESH_AXIS_EP = "ep"        # expert parallel (MoE)
MESH_AXIS_PP = "pp"        # pipeline parallel (layer stages)
MESH_AXIS_SP = "sp"        # sequence/context parallel (ring attention)
MESH_AXIS_TP = "tp"        # tensor parallel (heads / mlp / vocab)
AXES = (MESH_AXIS_DP, MESH_AXIS_FSDP, MESH_AXIS_EP, MESH_AXIS_PP,
        MESH_AXIS_SP, MESH_AXIS_TP)


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), an axis name, or a
    tuple of axis names (the dimension split over their product, the first
    outermost), as ``jax.sharding.PartitionSpec``. Trailing dimensions not
    named are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def spec_axes(spec) -> set:
    """The mesh axes a spec names."""
    out: set = set()
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            out.update(entry)
        else:
            out.add(entry)
    return out


def entry_axes(entry) -> tuple:
    """The axes of one spec entry, as a tuple (() for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


# ---------------------------------------------------------------- the mesh

def _world():
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group is initialised: start the "
            "ranks with ray_tpu_torch.parallel.launch (or call "
            "torch.distributed.init_process_group) before building a mesh")
    return dist


def _device_type() -> str:
    """The mesh's device type: "cuda" under NCCL; "cpu" under gloo, whose
    groups take CPU and CUDA tensors alike."""
    return "cuda" if _world().get_backend() == "nccl" else "cpu"


def _device_mesh(ranks):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_device_type(), torch.as_tensor(ranks),
                      mesh_dim_names=AXES)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.dp, self.fsdp, self.ep, self.pp, self.sp, self.tp)

    def size(self) -> int:
        return math.prod(self.shape)

    @classmethod
    def auto(cls, n_devices: int | None = None, *, fsdp: int = 1, ep: int = 1,
             pp: int = 1, sp: int = 1, tp: int = 1) -> "MeshSpec":
        """Fill dp with whatever ranks remain after the explicit axes;
        `n_devices` defaults to the world size."""
        n = n_devices if n_devices is not None else _world().get_world_size()
        rest = fsdp * ep * pp * sp * tp
        if n % rest != 0:
            raise ValueError(f"{n} devices not divisible by fsdp*ep*pp*sp*tp={rest}")
        return cls(dp=n // rest, fsdp=fsdp, ep=ep, pp=pp, sp=sp, tp=tp)

    def build(self, devices: Sequence[int] | None = None):
        """The DeviceMesh over `devices` (global ranks, default the whole
        world; taken in ascending order, which makes each axis' index its
        rank in the axis' process group) with dimension names AXES. Every
        rank of the world calls it, as torch.distributed's group creation
        needs."""
        dist = _world()
        devices = sorted(devices) if devices is not None else \
            list(range(dist.get_world_size()))
        n = self.size()
        if len(devices) < n:
            raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
        ranks = torch.as_tensor(devices[:n]).reshape(self.shape)
        return _device_mesh(ranks)


def hybrid_mesh(*, dcn_dp: int | None = None, fsdp: int = 1, ep: int = 1,
                pp: int = 1, sp: int = 1, tp: int = 1,
                devices: Sequence[int] | None = None,
                ranks_per_node: int | None = None):
    """Multi-node mesh: data parallelism across nodes, the other axes inside
    each node (gradients cross the slow inter-node network once per step,
    everything bandwidth-hungry stays on NVLink). dp leads over node-major
    ranks: ranks are ordered by (node, rank), node = rank // ranks_per_node
    (default: the visible CUDA devices per node, or the whole world on the
    CPU). `dcn_dp` defaults to the number of nodes; dp = dcn_dp x the ranks
    each node has left after fsdp*ep*pp*sp*tp."""
    dist = _world()
    devices = list(devices) if devices is not None else \
        list(range(dist.get_world_size()))
    if ranks_per_node is None:
        ranks_per_node = (torch.cuda.device_count() if _device_type() == "cuda"
                          else 0) or len(devices)
    n_nodes = len({r // ranks_per_node for r in devices})
    dcn_dp = dcn_dp if dcn_dp is not None else max(1, n_nodes)
    if len(devices) % dcn_dp != 0:
        raise ValueError(
            f"{len(devices)} devices not divisible by dcn_dp={dcn_dp}")
    per_node = len(devices) // dcn_dp
    ici = fsdp * ep * pp * sp * tp
    if per_node % ici != 0:
        raise ValueError(
            f"{per_node} per-node devices not divisible by "
            f"fsdp*ep*pp*sp*tp={ici}")
    ici_dp = per_node // ici
    order = sorted(devices, key=lambda r: (r // ranks_per_node, r))
    ranks = torch.as_tensor(order[:dcn_dp * per_node]).reshape(
        (dcn_dp * ici_dp, fsdp, ep, pp, sp, tp))
    return _device_mesh(ranks)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a MeshSpec."""
    if isinstance(mesh, MeshSpec):
        return dict(zip(AXES, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size_of(mesh, axis) -> int:
    """Size of one axis, or of a tuple of axes (their product); an axis the
    mesh does not have counts 1."""
    shape = mesh_shape(mesh)
    return math.prod(shape.get(a, 1) for a in entry_axes(axis))


def axis_rank(mesh, axis) -> int:
    """This rank's index along an axis, or along a tuple of axes (row-major,
    the first outermost); an axis the mesh does not have is index 0."""
    idx = 0
    shape = mesh_shape(mesh)
    for a in entry_axes(axis):
        if a in shape:
            idx = idx * shape[a] + mesh.get_local_rank(a)
    return idx


def axis_group(mesh, axes):
    """The process group of the ranks that differ from this one only along
    `axes` (a name or a tuple of names). Groups over more than one axis are
    created on first use and kept on the mesh: every rank of the world must
    ask for the same axes in the same order, as
    ``torch.distributed.new_group`` needs."""
    import torch.distributed as dist

    axes = tuple(a for a in entry_axes(axes) if a in mesh.mesh_dim_names)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = mesh.__dict__.setdefault("_axis_groups", {})
    if axes not in groups:
        names = list(mesh.mesh_dim_names)
        ranks = mesh.mesh
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        perm = ranks.permute(*rest, *keep).reshape(
            -1, math.prod(ranks.shape[i] for i in keep))
        me = dist.get_rank()
        mine = None
        for row in perm.tolist():  # every rank creates every group
            g = dist.new_group(row)
            if me in row:
                mine = g
        groups[axes] = mine
    return groups[axes]


# ------------------------------------------------------- the current mesh

_current = threading.local()


@contextlib.contextmanager
def use_mesh(mesh, *, batch_axes=()):
    """Make `mesh` the calling thread's current mesh (None: no mesh), as
    the body of a shard_map binds its axis names. `batch_axes` names the
    axes the batch's rows are split over when the program stands for one
    global computation (the meshed train step, the JAX package's gspmd
    mode); a MoE layer then routes the global batch."""
    stack = _current.__dict__.setdefault("stack", [])
    stack.append((mesh, tuple(entry_axes(batch_axes))))
    try:
        yield mesh
    finally:
        stack.pop()


def current_mesh():
    """The calling thread's current mesh, or None."""
    stack = getattr(_current, "stack", None)
    return stack[-1][0] if stack else None


def checkpoint_context(inner=None):
    """A ``context_fn`` for non-reentrant ``torch.utils.checkpoint`` that
    recomputes under the forward's mesh: autograd runs a CUDA backward on
    its own device thread, where the forward thread's ``use_mesh`` is not
    current. `inner` is another context_fn (a selective-checkpoint
    policy's) whose contexts are kept."""
    stack = getattr(_current, "stack", None)
    state = stack[-1] if stack else None
    fwd, rec = inner() if inner is not None else (contextlib.nullcontext(),
                                                  contextlib.nullcontext())
    if state is None:
        return fwd, rec

    @contextlib.contextmanager
    def recompute():
        with use_mesh(state[0], batch_axes=state[1]), rec:
            yield

    return fwd, recompute()


def current_batch_axes() -> tuple | None:
    """The current mesh's batch axes of size > 1 (see use_mesh), or
    None."""
    stack = getattr(_current, "stack", None)
    if not stack or stack[-1][0] is None:
        return None
    mesh, axes = stack[-1]
    axes = tuple(a for a in axes if axis_size_of(mesh, a) > 1)
    return axes or None


# ---------------------------------------------------------------- rules

# Logical dimension names used by models; rules map them to mesh axes.
# Separate tables for parameters vs activations (t5x-style): e.g. "embed" is
# sharded over fsdp in parameters (ZeRO-3) but replicated in activations.
@dataclasses.dataclass(frozen=True)
class ShardingRules:
    params: Mapping[str, Any]
    acts: Mapping[str, Any]

    def param_spec(self, logical: Sequence[str | None]) -> PartitionSpec:
        return P(*(self.params.get(d) if d is not None else None
                   for d in logical))

    def act_spec(self, logical: Sequence[str | None]) -> PartitionSpec:
        return P(*(self.acts.get(d) if d is not None else None
                   for d in logical))


DEFAULT_RULES = ShardingRules(
    params={
        "vocab": MESH_AXIS_TP,
        "embed": MESH_AXIS_FSDP,  # ZeRO-3-style weight shard, gathered at use
        "heads": MESH_AXIS_TP,
        "kv_heads": MESH_AXIS_TP,
        "head_dim": None,
        "mlp": MESH_AXIS_TP,
        "expert": MESH_AXIS_EP,
        "layers": None,
        "stage": MESH_AXIS_PP,
    },
    acts={
        "batch": (MESH_AXIS_DP, MESH_AXIS_FSDP),  # global batch over both
        "seq": MESH_AXIS_SP,
        "embed": None,
        "heads": MESH_AXIS_TP,
        "kv_heads": MESH_AXIS_TP,
        "head_dim": None,
        "mlp": MESH_AXIS_TP,
        "vocab": MESH_AXIS_TP,
        "expert": MESH_AXIS_EP,
        "stage": MESH_AXIS_PP,
    },
)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: where each dimension of a full tensor lives."""

    mesh: Any
    spec: PartitionSpec

    def shard_shape(self, shape) -> tuple:
        out = list(shape)
        for i, entry in enumerate(self.spec):
            n = axis_size_of(self.mesh, entry)
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} not divisible "
                                 f"by {entry}={n}")
            out[i] //= n
        return tuple(out)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of `full` (the same on every rank), as a new
        contiguous tensor: contiguous blocks, in mesh order."""
        return shard_tensor(full, self.spec, self.mesh)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's shard (not differentiable;
        ``collectives.allgather`` is)."""
        return gather_tensor(local, self.spec, self.mesh)


def shard_tensor(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    out = full
    for dim, entry in enumerate(spec):
        n = axis_size_of(mesh, entry)
        if n == 1:
            continue
        size = out.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} not "
                             f"divisible by {entry}={n}")
        out = out.narrow(dim, axis_rank(mesh, entry) * (size // n), size // n)
    return out.contiguous() if out is not full else out.clone()


def gather_tensor(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    from ray_tpu_torch.parallel import collectives

    out = local.detach()
    with use_mesh(mesh):
        for dim, entry in enumerate(spec):
            if entry is not None and axis_size_of(mesh, entry) > 1:
                out = collectives.allgather(out, entry, axis=dim)
    return out


def sharding_for(mesh, spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, PartitionSpec)


def tree_map(fn, tree, *rest, is_leaf=None):
    """map over nested dicts (the port's param trees), leaves by
    `is_leaf` (default: anything that is not a dict)."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    return fn(tree, *rest)


def param_specs(logical_tree, rules: ShardingRules = DEFAULT_RULES):
    """Map a tree of logical-axis tuples to PartitionSpecs."""
    return tree_map(rules.param_spec, logical_tree, is_leaf=_is_logical)


def param_shardings(mesh, logical_tree, rules: ShardingRules = DEFAULT_RULES):
    """Map a tree of logical-axis tuples to NamedShardings."""
    return tree_map(lambda logical: NamedSharding(mesh,
                                                  rules.param_spec(logical)),
                    logical_tree, is_leaf=_is_logical)


def act_sharding(mesh, *logical: str | None,
                 rules: ShardingRules = DEFAULT_RULES) -> NamedSharding:
    return NamedSharding(mesh, rules.act_spec(logical))


def constrain(x, mesh, *logical: str | None,
              rules: ShardingRules = DEFAULT_RULES):
    """Return `x` as it is. Under ``with_sharding_constraint`` XLA may
    reshard; a rank's tensor here is already its local shard and its global
    shape is not known, so this only checks that every dim the logical axes
    shard under `rules` exists in `x`."""
    spec = rules.act_spec(logical)
    for dim, entry in enumerate(spec):
        if entry is not None and axis_size_of(mesh, entry) > 1 and \
                dim >= x.dim():
            raise ValueError(f"{tuple(x.shape)} has no dim {dim} for {entry}")
    return x


def local_mesh_devices(platform: str = "cpu", n: int | None = None):
    """The devices of this host for `platform` ("cuda" or "cpu"), as
    ``torch.device`` objects (the CPU is one device). Raises for "cuda"
    when no GPU is visible."""
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("local_mesh_devices('cuda'): no CUDA device "
                               "is available")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif platform == "cpu":
        devs = [torch.device("cpu")]
    else:
        raise ValueError(f"platform must be 'cuda' or 'cpu', got {platform!r}")
    return devs if n is None else devs[:n]
