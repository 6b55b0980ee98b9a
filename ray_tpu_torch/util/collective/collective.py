"""Actor-oriented collectives over the host plane.

(reference: python/ray/util/collective/collective.py —
init_collective_group:180, create_collective_group:217, ops :325-738,
GroupManager:75.) Counterpart of ray_tpu/util/collective/collective.py.
The reference backends are NCCL/Gloo/NIXL; the port has two planes:

- DEVICE tensors: torch.distributed collectives (gloo or NCCL) inside the
  program, built with ray_tpu_torch.parallel. This module does not move
  device tensors.
- HOST tensors (numpy): this module — a ring over the shared rendezvous
  actor and the object store, used for control-plane sync, the host ZeRO
  plane (train/zero.py) and CPU preprocessing.

Every rank calls the same ops in the same order (the standard collective
contract), so a per-group monotonically increasing sequence number names
each operation's rendezvous.
"""

from __future__ import annotations

import logging
import time
from typing import NamedTuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.exceptions import CollectiveError
from ray_tpu_torch.util.collective import quantization

logger = logging.getLogger(__name__)

_groups: dict[str, "_GroupHandle"] = {}  # group_name → this process's handle

# Opt-in wire compressions for the reduction collectives. "int8_block" is
# EQuARX-style per-block-absmax int8 with error feedback (quantization.py):
# ~3.9x fewer bytes per hop, residual carried per (group, ef_key, hop site)
# so repeated calls telescope instead of drifting.
COMPRESSIONS = ("int8_block",)


def _check_compression(compression: str | None, op: str,
                       dtype: np.dtype) -> None:
    if compression is None:
        return
    if compression not in COMPRESSIONS:
        raise ValueError(f"unknown compression {compression!r}; "
                         f"supported: {COMPRESSIONS}")
    if op not in ("sum", "mean"):
        raise ValueError(
            f"compression={compression!r} only composes with op in "
            "('sum', 'mean'): quantization error feedback corrects a "
            f"telescoping sum, not order statistics like {op!r}")
    if not np.issubdtype(dtype, np.floating):
        raise ValueError(
            f"compression={compression!r} needs a floating dtype, got {dtype}")


def _coll_metrics():
    from ray_tpu_torch.util import metrics as met

    c = met.get_or_create(
        met.Counter, "ray_tpu_collective_bytes_total",
        "Per-rank payload bytes put on the wire by host-plane collectives.",
        tag_keys=("op", "compression"))
    h = met.get_or_create(
        met.Histogram, "ray_tpu_collective_seconds",
        "Wall time of host-plane collective calls.",
        tag_keys=("op", "compression"))
    return c, h


def _record_collective(op_kind: str, compression: str | None, nbytes: int,
                       seconds: float) -> None:
    counter, hist = _coll_metrics()
    tags = {"op": op_kind, "compression": compression or "none"}
    counter.inc(nbytes, tags)
    hist.observe(seconds, tags)


def _record_failure(kind: str) -> None:
    from ray_tpu_torch.util import metrics as met

    met.get_or_create(
        met.Counter, "ray_tpu_collective_failures_total",
        "Host-plane collective failures: peer_death (liveness polling "
        "caught a dead rank mid-wait), aborted (the group was poisoned by "
        "another rank's detection), timeout (the data wait expired).",
        tag_keys=("kind",)).inc(tags={"kind": kind})


@ray_tpu_torch.remote
class _Rendezvous:
    """Per-group state: contributions keyed by (seq, rank)."""

    def __init__(self, world_size: int):
        self.n = world_size
        self.contribs: dict[int, dict[int, bytes]] = {}    # collectives by seq
        self.consumed: dict[int, set[int]] = {}
        self.mailbox: dict[tuple, bytes] = {}              # p2p: disjoint namespace
        # rank → actor id registered at join (None for a driver rank):
        # survivors poll these via actor_info for peer liveness
        self.members: dict[int, str | None] = {}
        # group-level poison: first detection wins; every subsequent wait on
        # the group fails fast instead of re-entering a doomed collective
        self.abort_info: dict | None = None

    def register(self, rank: int, aid: str | None) -> dict:
        """Record this rank's actor id; returns the members seen so far."""
        self.members[rank] = aid
        return dict(self.members)

    def members_map(self) -> dict:
        return dict(self.members)

    def abort(self, rank: int, reason: str, dead_ranks: tuple = ()) -> None:
        if self.abort_info is None:
            self.abort_info = {"rank": rank, "reason": reason,
                               "dead_ranks": tuple(dead_ranks)}

    def get_abort(self) -> dict | None:
        return self.abort_info

    def put(self, seq: int, rank: int, blob: bytes) -> None:
        self.contribs.setdefault(seq, {})[rank] = blob

    def poll(self, seq: int, rank: int):
        """All contributions if complete (marking this rank's read), else None."""
        got = self.contribs.get(seq, {})
        if len(got) < self.n:
            return None
        out = dict(got)
        done = self.consumed.setdefault(seq, set())
        done.add(rank)
        if len(done) >= self.n:  # everyone has read: free the slot
            self.contribs.pop(seq, None)
            self.consumed.pop(seq, None)
        return out

    def put_p2p(self, tag: int, src: int, dst: int, blob: bytes) -> bool:
        """False while the slot is occupied (an unconsumed earlier send)."""
        key = (tag, src, dst)
        if key in self.mailbox:
            return False
        self.mailbox[key] = blob
        return True

    def poll_p2p(self, tag: int, src: int, dst: int):
        return self.mailbox.pop((tag, src, dst), None)


class _GroupHandle:
    def __init__(self, name: str, world_size: int, rank: int, actor):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.actor = actor
        self.seq = 0
        # rank → actor id (from the rendezvous membership table) for peer
        # liveness probes; None entries are driver ranks (not probeable)
        self.peer_aids: dict[int, str | None] = {}
        # local mirror of the group poison flag: once set, every wait on
        # this group fails fast with CollectiveError(kind="aborted")
        self.aborted: str | None = None

    def next_seq(self) -> int:
        self.seq += 1
        return self.seq


def _rendezvous_name(group_name: str) -> str:
    return f"__collective::{group_name}"


def init_collective_group(world_size: int, rank: int, *, backend: str = "host",
                          group_name: str = "default",
                          timeout: float | None = None) -> None:
    """Join (rank 0 creates) the named group. Called by each participant.
    (reference: collective.py:180.)

    Blocks until every rank has registered with the rendezvous — the
    membership (rank → actor id) table is what peer-liveness probes read,
    so it must be complete before the first op. `timeout` defaults to
    RayConfig.collective_group_create_timeout_s; on expiry the error names
    the ranks that never arrived."""
    from ray_tpu_torch._private.ray_config import RayConfig

    if group_name in _groups:
        raise ValueError(f"already in collective group {group_name!r}")
    if timeout is None:
        timeout = RayConfig.get("collective_group_create_timeout_s")
    name = _rendezvous_name(group_name)
    deadline = time.monotonic() + timeout
    if rank == 0:
        actor = _Rendezvous.options(name=name, namespace="_system",
                            num_cpus=0.1).remote(world_size)
        actor.__ray_ready__()
    else:
        while True:
            try:
                actor = ray_tpu_torch.get_actor(name, namespace="_system")
                break
            except ValueError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"collective group {group_name!r} was never created "
                        f"within {timeout:.0f}s: rank 0 never started the "
                        "rendezvous") from None
                time.sleep(0.02)
    registered = ray_tpu_torch.get(actor.register.remote(rank, _self_aid()))
    while len(registered) < world_size:
        if time.monotonic() > deadline:
            missing = sorted(set(range(world_size)) - set(registered))
            raise TimeoutError(
                f"collective group {group_name!r}: rank(s) {missing} never "
                f"joined within {timeout:.0f}s "
                f"({len(registered)}/{world_size} registered)")
        time.sleep(0.02)
        registered = ray_tpu_torch.get(actor.members_map.remote())
    g = _GroupHandle(group_name, world_size, rank, actor)
    g.peer_aids = dict(registered)
    _groups[group_name] = g


def create_collective_group(actors: list, world_size: int, ranks: list[int], *,
                            backend: str = "host", group_name: str = "default",
                            timeout: float | None = None):
    """Declarative setup from the driver: tells every actor to join.
    The actors must expose the conventional `init_collective_group(world_size,
    rank, backend, group_name)` method (reference: collective.py:217 uses the
    same information-push pattern).

    `timeout` (default RayConfig.collective_group_create_timeout_s) bounds
    the driver-side gather with a small slack so each rank's in-actor
    deadline — which names the missing ranks — wins the race; set the env
    override RAY_TPU_TORCH_COLLECTIVE_GROUP_CREATE_TIMEOUT_S to tighten the
    in-actor deadline itself (spawn_env forwards it to workers)."""
    from ray_tpu_torch._private.ray_config import RayConfig

    if timeout is None:
        timeout = RayConfig.get("collective_group_create_timeout_s")
    refs = [a.init_collective_group.remote(world_size, r, backend, group_name)
            for a, r in zip(actors, ranks)]
    ray_tpu_torch.get(refs, timeout=timeout + 10.0)


def destroy_collective_group(group_name: str = "default") -> None:
    g = _groups.pop(group_name, None)
    quantization.release_group_residuals(group_name)
    if g is not None and g.rank == 0:
        try:
            ray_tpu_torch.kill(g.actor)
        except Exception:
            pass


def get_rank(group_name: str = "default") -> int:
    return _groups[group_name].rank


def get_world_size(group_name: str = "default") -> int:
    return _groups[group_name].world_size


def _group(group_name: str) -> _GroupHandle:
    if group_name not in _groups:
        raise ValueError(
            f"not a member of collective group {group_name!r}; call "
            "init_collective_group first")
    return _groups[group_name]


# --------------------------------------------------------- failure detection

def _self_aid() -> str | None:
    """This process's actor id (None on a driver rank)."""
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod._global_worker
    return getattr(w, "current_actor_id", None) if w is not None else None


def _member_aids(g: _GroupHandle) -> dict:
    """rank → actor id map from the rendezvous membership table (cached
    once complete; refreshed while ranks are still joining)."""
    if len(g.peer_aids) < g.world_size:
        try:
            g.peer_aids = ray_tpu_torch.get(g.actor.members_map.remote())
        except Exception as e:
            logger.debug("collective members_map fetch failed: %s", e)
    return g.peer_aids


def _probe_dead_ranks(g: _GroupHandle) -> list[int]:
    """One liveness sweep of all peer ranks via the GCS actor table.

    A rank is dead iff the GCS says its actor is gone or state == "dead";
    RPC errors are inconclusive (a GCS hiccup must not poison a healthy
    group), and driver ranks (aid None) are never probed."""
    from ray_tpu_torch._private import worker as worker_mod

    w = worker_mod._global_worker
    if w is None:
        return []
    dead: list[int] = []
    for rank, aid in sorted(_member_aids(g).items()):
        if rank == g.rank or aid is None:
            continue
        try:
            info = w.rpc({"type": "actor_info", "aid": aid}, timeout=10.0)
        except Exception as e:
            logger.debug("liveness probe for rank %s failed: %s", rank, e)
            continue
        if not info.get("found") or info.get("state") == "dead":
            dead.append(rank)
    return dead


def _mark_aborted(g: _GroupHandle, reason: str,
                  dead_ranks: tuple = ()) -> None:
    """Poison the group locally and (best-effort) on the rendezvous so
    every other survivor fails fast instead of re-entering a collective
    the dead rank can never complete. `dead_ranks` rides the flag so
    survivors that adopt the abort still name the dead peers."""
    g.aborted = reason
    try:
        g.actor.abort.remote(g.rank, reason, tuple(dead_ranks))
    except Exception as e:
        logger.debug("collective abort broadcast failed: %s", e)


def _liveness_check(g: _GroupHandle, what: str, seq: int | None) -> None:
    """One in-wait detection pass: adopt a group abort set by another rank,
    else probe peer liveness; raises CollectiveError on either."""
    try:
        info = ray_tpu_torch.get(g.actor.get_abort.remote())
    except Exception as e:
        logger.debug("collective abort-flag check failed: %s", e)
        info = None
    if info is not None:
        g.aborted = info.get("reason") or "aborted"
        _record_failure("aborted")
        raise CollectiveError(
            f"collective group {g.name!r} aborted by rank {info.get('rank')}: "
            f"{g.aborted}", group=g.name, seq=seq,
            dead_ranks=tuple(info.get("dead_ranks") or ()), kind="aborted")
    dead = _probe_dead_ranks(g)
    if dead:
        reason = (f"collective group {g.name!r}: rank(s) {dead} died "
                  f"(detected while waiting: {what})")
        _mark_aborted(g, reason, tuple(dead))
        _record_failure("peer_death")
        raise CollectiveError(reason, group=g.name, seq=seq,
                              dead_ranks=tuple(dead), kind="peer_death")


def _collective_wait(g: _GroupHandle, probe, timeout: float, what: str,
                     seq: int | None = None):
    """poll_until with peer-liveness awareness.

    While blocked on collective data, every collective_liveness_interval_s
    the wait (a) adopts a group-level abort set by another rank and (b)
    probes peer-actor liveness via the GCS — so a SIGKILLed rank surfaces
    on every survivor as CollectiveError naming the dead rank within
    ~the interval, never as an opaque TimeoutError after the full data
    timeout. On data-timeout expiry one final sweep runs regardless (the
    fallback when in-wait polling is disabled via interval 0), upgrading
    the TimeoutError to CollectiveError when it finds suspects."""
    from ray_tpu_torch._private.poll import _SLEEP_CAP, _SLEEP_INIT
    from ray_tpu_torch._private.ray_config import RayConfig

    if g.aborted:
        _record_failure("aborted")
        raise CollectiveError(
            f"collective group {g.name!r} is aborted: {g.aborted}",
            group=g.name, seq=seq, kind="aborted")
    interval = RayConfig.instance().collective_liveness_interval_s
    deadline = time.monotonic() + timeout
    next_check = (time.monotonic() + interval) if interval > 0 else None
    sleep_s = _SLEEP_INIT
    while True:
        out = probe()
        if out is not None:
            return out
        now = time.monotonic()
        if now > deadline:
            break
        if next_check is not None and now >= next_check:
            _liveness_check(g, what, seq)
            next_check = time.monotonic() + interval
        time.sleep(min(sleep_s, max(deadline - now, 0.0)))
        sleep_s = min(sleep_s * 2, _SLEEP_CAP)
    dead = _probe_dead_ranks(g)
    _record_failure("timeout")
    if dead:
        reason = (f"collective group {g.name!r}: rank(s) {dead} suspected "
                  f"dead (liveness sweep at timeout of: {what})")
        _mark_aborted(g, reason, tuple(dead))
        raise CollectiveError(reason, group=g.name, seq=seq,
                              dead_ranks=tuple(dead), kind="timeout")
    raise TimeoutError(what)


def _exchange(g: _GroupHandle, payload, timeout: float) -> dict:
    from ray_tpu_torch._private import serialization as ser

    seq = g.next_seq()
    g.actor.put.remote(seq, g.rank, ser.dumps(payload))
    got = _collective_wait(
        g, lambda: ray_tpu_torch.get(g.actor.poll.remote(seq, g.rank)),
        timeout, f"collective seq {seq} timed out on rank {g.rank}", seq=seq)
    return {r: ser.loads(b) for r, b in got.items()}


# Above this many bytes, tensors stop flowing THROUGH the rendezvous actor:
# ranks exchange ObjectRefs (about a hundred bytes each) and the payloads
# ride the per-host object plane directly between the hosts involved — the
# actor's traffic stays O(world) small messages per op regardless of tensor
# size, and reductions run as a chunked ring so per-rank bytes moved are
# ~2x tensor size independent of world size.
# (reference: ring allreduce in nccl_collective_group.py:121; the host-plane
# gloo backend uses the same ring for big tensors.)
RING_MIN_BYTES = 1 << 20


def _combine(a: np.ndarray, b: np.ndarray, op: str) -> np.ndarray:
    if op in ("sum", "mean"):
        return a + b
    if op == "max":
        return np.maximum(a, b)
    if op == "min":
        return np.minimum(a, b)
    if op == "prod":
        return a * b
    raise ValueError(f"unknown reduce op {op!r}")


def _ring_send(g: _GroupHandle, dst: int, tag, ref, timeout: float):
    # ring tags are tuples — a namespace user send()/recv() int tags can't
    # collide with in the shared p2p mailbox
    from ray_tpu_torch._private import serialization as ser

    blob = ser.dumps(ref)
    _collective_wait(
        g,
        lambda: ray_tpu_torch.get(g.actor.put_p2p.remote(tag, g.rank, dst, blob)) or None,
        timeout, f"ring send to rank {dst} (tag {tag}) timed out",
        seq=tag[1] if isinstance(tag, tuple) else None)


def _ring_recv(g: _GroupHandle, src: int, tag, timeout: float) -> np.ndarray:
    from ray_tpu_torch._private import serialization as ser

    blob = _collective_wait(
        g,
        lambda: ray_tpu_torch.get(g.actor.poll_p2p.remote(tag, src, g.rank)),
        timeout, f"ring recv from rank {src} (tag {tag}) timed out",
        seq=tag[1] if isinstance(tag, tuple) else None)
    return ray_tpu_torch.get(ser.loads(blob))


def _ring_reduce_phase(g: _GroupHandle, buffers: list, op: str, seq: int,
                       keep: list, timeout: float, *,
                       compression: str | None = None,
                       ef_key: str | None = None,
                       sent_bytes: list | None = None) -> None:
    """In-place ring reduce-scatter over `buffers` (one chunk per rank):
    after W-1 steps, buffers[(rank+1) % W] holds the full reduction.

    With compression, every hop's partial sum is quantized before the send
    (its own error-feedback site, keyed by step index — stable across
    calls) and dequantized+combined on receive."""
    W, rank = g.world_size, g.rank
    nxt, prv = (rank + 1) % W, (rank - 1) % W
    for s in range(W - 1):
        si = (rank - s) % W
        ri = (rank - s - 1) % W
        payload = buffers[si]
        if compression == "int8_block":
            payload = quantization.quantize_with_feedback(
                payload, g.name, ef_key or "", f"rs:{s}")
        if sent_bytes is not None:
            sent_bytes[0] += quantization.wire_bytes(payload)
        ref = ray_tpu_torch.put(payload)
        keep.append(ref)  # alive until the end-of-op barrier
        _ring_send(g, nxt, ("__ring__", seq, s), ref, timeout)
        inc = _ring_recv(g, prv, ("__ring__", seq, s), timeout)
        if isinstance(inc, quantization.QuantizedChunk):
            inc = quantization.dequantize_block(inc)
        buffers[ri] = _combine(buffers[ri], inc, op)


def _flat_chunks(tensor: np.ndarray, W: int, op: str):
    """Flatten + pad to W equal chunks (the ring layout). Returns
    (chunk list, original element count, chunk size)."""
    flat = np.ascontiguousarray(tensor).ravel()
    n = flat.size
    per = -(-n // W)
    padded = np.resize(flat, per * W) if per * W != n else flat
    if per * W != n:
        padded[n:] = 0 if op in ("sum", "mean") else flat[-1]
    return [padded[i * per:(i + 1) * per].copy() for i in range(W)], n, per


def _ring_allreduce(g: _GroupHandle, tensor: np.ndarray, op: str,
                    timeout: float, compression: str | None = None,
                    ef_key: str | None = None) -> tuple[np.ndarray, int]:
    """Chunked ring allreduce: reduce-scatter then allgather, payloads by
    ref through the object plane (reference: the standard 2(W-1)-step ring,
    nccl_collective_group.py:121). Returns (result, per-rank wire bytes).

    Compressed mode quantizes each reduce-phase hop (with per-hop error
    feedback) and each rank's fully-reduced chunk ONCE at allgather
    injection; forwarding ranks relay the quantized payload verbatim, and
    the injecting rank adopts its own dequantized copy — so every rank
    reconstructs bit-identical values and replicas cannot diverge."""
    W, rank = g.world_size, g.rank
    nxt, prv = (rank + 1) % W, (rank - 1) % W
    buffers, n, per = _flat_chunks(tensor, W, op)
    keep: list = []
    sent = [0]
    seq = g.next_seq()
    _ring_reduce_phase(g, buffers, op, seq, keep, timeout,
                       compression=compression, ef_key=ef_key,
                       sent_bytes=sent)
    # allgather phase: circulate the reduced chunks
    seq2 = g.next_seq()
    if compression == "int8_block":
        own = (rank + 1) % W
        carry = quantization.quantize_with_feedback(
            buffers[own], g.name, ef_key or "", "ag")
        buffers[own] = quantization.dequantize_block(carry)
        for s in range(W - 1):
            ri = (rank - s) % W
            sent[0] += carry.wire_bytes
            ref = ray_tpu_torch.put(carry)
            keep.append(ref)
            _ring_send(g, nxt, ("__ring__", seq2, s), ref, timeout)
            carry = _ring_recv(g, prv, ("__ring__", seq2, s), timeout)
            buffers[ri] = quantization.dequantize_block(carry)
    else:
        for s in range(W - 1):
            si = (rank + 1 - s) % W
            ri = (rank - s) % W
            sent[0] += buffers[si].nbytes
            ref = ray_tpu_torch.put(buffers[si])
            keep.append(ref)
            _ring_send(g, nxt, ("__ring__", seq2, s), ref, timeout)
            buffers[ri] = _ring_recv(g, prv, ("__ring__", seq2, s), timeout)
    _exchange(g, None, timeout)  # all pulls done before refs drop
    keep.clear()
    out = np.concatenate(buffers)[:n].reshape(tensor.shape)
    if op == "mean":
        out = out / W
    return (out.astype(tensor.dtype) if op != "mean" else out), sent[0]


def _default_ef_key(kind: str, op: str, tensor: np.ndarray) -> str:
    # stable per (call kind, op, shape, dtype): the collective contract
    # already requires every rank to issue the same ops in the same order
    # with the same shapes, so this names "the same allreduce" across
    # iterations. Callers mixing several same-shaped tensors per iteration
    # pass an explicit ef_key to keep their residuals apart.
    return f"{kind}:{op}:{tensor.shape}:{tensor.dtype}"


def allreduce(tensor: np.ndarray, *, op: str = "sum",
              group_name: str = "default", timeout: float = 60.0,
              compression: str | None = None,
              ef_key: str | None = None) -> np.ndarray:
    """(reference: collective.py allreduce:325.)

    Every rank MUST pass the same shape and dtype (the standard collective
    contract — NCCL requires it too): the ring-vs-star choice is made from
    the local tensor's byte size, and uniform inputs guarantee all ranks
    choose the same path.

    compression="int8_block" (sum/mean, float dtypes) rides the ring
    regardless of size, block-quantizing every hop with per-site error
    feedback keyed by `ef_key` (defaults to op+shape+dtype)."""
    g = _group(group_name)
    tensor = np.asarray(tensor)
    _check_compression(compression, op, tensor.dtype)
    t0 = time.perf_counter()
    if g.world_size > 1 and (compression is not None
                             or tensor.nbytes >= RING_MIN_BYTES):
        if compression is not None and ef_key is None:
            ef_key = _default_ef_key("allreduce", op, tensor)
        out, sent = _ring_allreduce(g, tensor, op, timeout, compression,
                                    ef_key)
        _record_collective("allreduce", compression, sent,
                           time.perf_counter() - t0)
        return out
    parts = _exchange(g, tensor, timeout)
    stack = np.stack([parts[r] for r in range(g.world_size)])
    if op == "sum":
        out = stack.sum(axis=0)
    elif op == "mean":
        out = stack.mean(axis=0)
    elif op == "max":
        out = stack.max(axis=0)
    elif op == "min":
        out = stack.min(axis=0)
    elif op == "prod":
        out = stack.prod(axis=0)
    else:
        raise ValueError(f"unknown reduce op {op!r}")
    _record_collective("allreduce", None, tensor.nbytes,
                       time.perf_counter() - t0)
    return out


def reduce(tensor: np.ndarray, *, dst_rank: int = 0, op: str = "sum",
           group_name: str = "default", timeout: float = 60.0):
    """Result lands on dst_rank; others get None. (reference: :414.)"""
    out = allreduce(tensor, op=op, group_name=group_name, timeout=timeout)
    return out if _group(group_name).rank == dst_rank else None


def broadcast(tensor: np.ndarray | None, *, src_rank: int = 0,
              group_name: str = "default", timeout: float = 60.0) -> np.ndarray:
    """(reference: :482.) Large tensors go by ref: the source puts once and
    receivers pull host-to-host through the object plane (each pulled copy
    registers as a location, so later pulls fan out across hosts)."""
    g = _group(group_name)
    payload = np.asarray(tensor) if g.rank == src_rank else None
    big = (payload is not None and payload.nbytes >= RING_MIN_BYTES
           and g.world_size > 1)
    to_send = ray_tpu_torch.put(payload) if big else payload
    # every rank runs the SAME exchange sequence regardless of mode — the
    # src's payload type (array vs ref) tells receivers which it was
    parts = _exchange(g, to_send, timeout)
    got = parts[src_rank]
    is_ref = hasattr(got, "hex")
    if g.rank == src_rank:
        # no re-fetch of our own payload — but return an independent copy,
        # matching what every other rank receives
        out = payload.copy()
    else:
        out = ray_tpu_torch.get(got) if is_ref else got
    if is_ref or big:
        # same predicate on every rank (receivers see the ref; the src knows
        # it sent one): the src's ref stays live until everyone pulled
        _exchange(g, None, timeout)
    return out


def allgather(tensor: np.ndarray, *, group_name: str = "default",
              timeout: float = 60.0, compression: str | None = None,
              ef_key: str | None = None) -> list[np.ndarray]:
    """(reference: :554.) Per-rank tensors may differ in shape/size; each
    rank independently ships either the array (small) or a ref (large) and
    receivers resolve by payload type, so mixed modes can't diverge.

    compression="int8_block" quantizes this rank's contribution once at
    the source (error feedback keyed by ef_key); every rank — including
    the source, which adopts its own dequantized copy — reconstructs the
    same values."""
    g = _group(group_name)
    tensor = np.asarray(tensor)
    t0 = time.perf_counter()
    payload: object = tensor
    if compression is not None:
        _check_compression(compression, "sum", tensor.dtype)
        if ef_key is None:
            ef_key = _default_ef_key("allgather", "id", tensor)
        payload = quantization.quantize_with_feedback(
            tensor, g.name, ef_key, "allgather")
    nbytes = quantization.wire_bytes(payload)
    big_mine = nbytes >= RING_MIN_BYTES and g.world_size > 1
    to_send = ray_tpu_torch.put(payload) if big_mine else payload
    parts = _exchange(g, to_send, timeout)
    saw_ref = big_mine or any(hasattr(parts[r], "hex")
                              for r in range(g.world_size))

    def _resolve(r: int):
        if r == g.rank:
            # no re-fetch of our own payload through the object store; the
            # compressed path still adopts the DEQUANTIZED copy so every
            # rank reconstructs bit-identical values
            if isinstance(payload, quantization.QuantizedChunk):
                return quantization.dequantize_block(payload).reshape(
                    payload.shape)
            return tensor.copy()
        p = parts[r]
        if hasattr(p, "hex"):
            p = ray_tpu_torch.get(p)
        if isinstance(p, quantization.QuantizedChunk):
            return quantization.dequantize_block(p).reshape(p.shape)
        return p

    out = [_resolve(r) for r in range(g.world_size)]
    if saw_ref:
        # every rank computed the same predicate from the same exchanged
        # data: refs stay live until all pulls completed
        _exchange(g, None, timeout)
    _record_collective("allgather", compression, nbytes,
                       time.perf_counter() - t0)
    return out


def reducescatter(tensor: np.ndarray, *, op: str = "sum",
                  group_name: str = "default", timeout: float = 60.0,
                  compression: str | None = None,
                  ef_key: str | None = None) -> np.ndarray:
    """Reduce then return this rank's 1/world shard along axis 0.
    (reference: :629. Rides allreduce, which is a scalable ring for large
    tensors; the local slice is free.) `compression` forwards to the ring
    (see allreduce); ZeRO-style flat sharding wants `reducescatter_flat`,
    which runs ONLY the reduce phase — half the bytes."""
    g = _group(group_name)
    total = allreduce(tensor, op=op, group_name=group_name, timeout=timeout,
                      compression=compression, ef_key=ef_key)
    shards = np.array_split(total, g.world_size, axis=0)
    return shards[g.rank]


class FlatShard(NamedTuple):
    """This rank's chunk of a flattened ring-reduced tensor."""

    chunk: np.ndarray    # [chunk_size] reduced values (padded tail zeros)
    index: int           # which of the W flat chunks this rank owns
    chunk_size: int      # elements per chunk (ceil(n / W))
    total_size: int      # original (unpadded) element count


def reducescatter_flat(tensor: np.ndarray, *, op: str = "sum",
                       group_name: str = "default", timeout: float = 60.0,
                       compression: str | None = None,
                       ef_key: str | None = None) -> FlatShard:
    """Ring reduce-scatter over the FLAT tensor: runs only the reduce
    phase (W-1 hops, ~half an allreduce's bytes) and returns the one chunk
    this rank ends up owning — the input to a ZeRO-1 sharded optimizer
    update (train/zero.py). Chunk ownership follows the ring: rank r owns
    flat chunk (r+1) % W; reassemble with the indices, not the ranks."""
    g = _group(group_name)
    tensor = np.asarray(tensor)
    _check_compression(compression, op, tensor.dtype)
    if op not in ("sum", "mean"):
        raise ValueError(f"reducescatter_flat supports sum/mean, got {op!r}")
    t0 = time.perf_counter()
    W = g.world_size
    if W == 1:
        out = np.ascontiguousarray(tensor).ravel().copy()
        _record_collective("reducescatter", compression, 0,
                           time.perf_counter() - t0)
        return FlatShard(out, 0, out.size, out.size)
    if compression is not None and ef_key is None:
        ef_key = _default_ef_key("reducescatter", op, tensor)
    buffers, n, per = _flat_chunks(tensor, W, op)
    keep: list = []
    sent = [0]
    seq = g.next_seq()
    _ring_reduce_phase(g, buffers, op, seq, keep, timeout,
                       compression=compression, ef_key=ef_key,
                       sent_bytes=sent)
    _exchange(g, None, timeout)  # all pulls done before refs drop
    keep.clear()
    own = (g.rank + 1) % W
    chunk = buffers[own]
    if op == "mean":
        chunk = chunk / W
    _record_collective("reducescatter", compression, sent[0],
                       time.perf_counter() - t0)
    return FlatShard(np.asarray(chunk), own, per, n)


def barrier(group_name: str = "default", timeout: float = 60.0) -> None:
    """(reference: :738.)"""
    _exchange(_group(group_name), None, timeout)


def send(tensor: np.ndarray, dst_rank: int, *, group_name: str = "default",
         tag: int = 0, timeout: float = 60.0) -> None:
    """P2P send; pairs with recv on dst. Blocks while an earlier same-tag
    send to the same peer is unconsumed (mailbox backpressure).
    (reference: :666.)"""
    from ray_tpu_torch._private import serialization as ser

    g = _group(group_name)
    blob = ser.dumps(np.asarray(tensor))
    _collective_wait(
        g,
        lambda: ray_tpu_torch.get(g.actor.put_p2p.remote(tag, g.rank, dst_rank, blob)) or None,
        timeout, f"send to rank {dst_rank} (tag {tag}) timed out: receiver never drained")


def recv(src_rank: int, *, group_name: str = "default", tag: int = 0,
         timeout: float = 60.0) -> np.ndarray:
    """(reference: :702.)"""
    from ray_tpu_torch._private import serialization as ser

    g = _group(group_name)
    blob = _collective_wait(
        g,
        lambda: ray_tpu_torch.get(g.actor.poll_p2p.remote(tag, src_rank, g.rank)),
        timeout, f"recv from rank {src_rank} timed out")
    return ser.loads(blob)
