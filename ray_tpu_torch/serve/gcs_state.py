"""Durable serve control-plane state: the controller's GCS-backed table.

Reference capability: Serve keeps its entire control-plane state
checkpointed in the GCS so a crashed controller recovers without touching
running replicas (reference: serve/_private/controller.py:102 — the
checkpoint path —  and deployment_state.py's recovery, which re-targets
live replica actors instead of restarting them). Here the table is the
GCS `serve` sqlite table (gcs_storage.py, same WAL plane the autoscaler's
`instances` table rides), reached over three RPCs: serve_put /
serve_delete / serve_list.

Row key scheme (one flat keyspace, prefix-typed):

    meta              — {"version", "routes", "apps"}: the routing table's
                        version counter and route/app maps. Persisted on
                        every version bump so a recovered controller can
                        never hand a router a (version, content) pair that
                        collides with one it saw before the crash.
    dep:<full_name>   — one record per deployment: config dict, current
                        target, next replica index, nonce (names replica
                        actors uniquely across controller generations),
                        deleted flag. Mutable counters only — this row is
                        rewritten on every target/index move, so it must
                        stay small.
    blob:<full>:<nonce> — the deployment's callable/init-args pickles,
                        written ONCE per deployment generation (blobs are
                        immutable; a code change is a new generation with
                        a new nonce). Split from dep: so autoscaler target
                        moves and replica-index bumps never re-ship
                        multi-MB pickles through the GCS.
    rep:<full>:<tag>  — one row per replica: actor name (for named-actor
                        re-adoption), actor id, fast-RPC addr, state
                        ∈ {starting, running, unhealthy, draining,
                        stopping}, drain deadline (wall clock — must stay
                        meaningful across processes).
    proxy_plane       — the sharded proxy plane's config: ingress host,
                        pinned port, shard count, nonce (names the shm
                        routing segment and the shard actors), accept
                        mode (reuseport vs fd-passing), next shard
                        generation counter (burned before each shard
                        create, like dep next_idx).
    proxy:<index>     — one row per proxy shard: actor name (for
                        named-actor re-adoption), actor id, HTTP addr,
                        state ∈ {starting, running}.

The invariant consumers rely on (same contract as the autoscaler's
instance machine): **every mutation is persisted before its side effect
counts as durable** — the serve_put reply IS the durability ack, so a
controller killed at any single point leaves a table from which its
restarted incarnation converges without orphaning or double-starting a
replica.
"""

from __future__ import annotations

from typing import Callable, Dict

META_KEY = "meta"
PROXY_PLANE_KEY = "proxy_plane"


def dep_key(full_name: str) -> str:
    return f"dep:{full_name}"


def proxy_key(index: int) -> str:
    return f"proxy:{index}"


def rep_key(full_name: str, tag: str) -> str:
    return f"rep:{full_name}:{tag}"


def blob_key(full_name: str, nonce: str) -> str:
    return f"blob:{full_name}:{nonce}"


class ServeStateStore:
    """Write-through serve-table client over a synchronous GCS rpc callable
    (the controller passes its hosting worker's)."""

    def __init__(self, rpc: Callable[[dict], dict]):
        self._rpc = rpc

    def _call(self, msg: dict) -> dict:
        reply = self._rpc(msg)
        if reply.get("error") or reply.get("ok") is False:
            # the reply IS the durability ack: a failed sqlite write must
            # surface, or the controller would run side effects (replica
            # create/kill) with nothing persisted behind them
            raise RuntimeError(
                f"{msg['type']} failed at the GCS: "
                f"{reply.get('error') or 'not acknowledged'}")
        return reply

    def put(self, key: str, record: dict) -> None:
        self._call({"type": "serve_put", "key": key, "record": dict(record)})

    def delete(self, key: str) -> None:
        self._call({"type": "serve_delete", "key": key})

    def list(self, light: bool = False) -> Dict[str, dict]:
        """All rows; light=True omits the blob: rows (consumers that only
        read control state — the dashboard — must not ship pickles)."""
        return dict(self._call(
            {"type": "serve_list", **({"light": True} if light else {})}
        )["rows"])

    def keys(self) -> list:
        return list(self._call({"type": "serve_list",
                                "keys_only": True})["keys"])

    def clear(self) -> None:
        for key in self.keys():
            self.delete(key)


class MemoryServeStore:
    """Dict-backed store: unit tests, and the degrade path for runtimes
    without a GCS rpc plane (local mode) — no durability, same interface."""

    def __init__(self):
        self.rows: Dict[str, dict] = {}

    def put(self, key: str, record: dict) -> None:
        self.rows[key] = dict(record)

    def delete(self, key: str) -> None:
        self.rows.pop(key, None)

    def list(self, light: bool = False) -> Dict[str, dict]:
        return {k: dict(v) for k, v in self.rows.items()
                if not (light and k.startswith("blob:"))}

    def keys(self) -> list:
        return list(self.rows)

    def clear(self) -> None:
        self.rows.clear()


def gcs_serve_store():
    """The hosting worker's GCS-backed store, or a memory store when this
    runtime has no rpc plane (local mode)."""
    from ray_tpu_torch._private.api import _get_worker

    w = _get_worker()
    if not hasattr(w, "rpc"):
        return MemoryServeStore()
    return ServeStateStore(w.rpc)
