"""Pluggable request routing for DeploymentHandles.

Routers pick a replica for each request. `pow2` (default) is
power-of-two-choices on client-side in-flight counts; `prefix_aware` sends
requests sharing a prompt prefix to the replica that served that prefix
before — on an LLM deployment this maximizes KV-cache reuse — falling back
to pow2 when the sticky replica is overloaded.

(reference: python/ray/serve/_private/request_router/pow_2_router.py:27 and
llm/_internal/serve/request_router/prefix_aware/prefix_tree.py.)
"""

from __future__ import annotations

import threading

# imbalance tolerance: prefer the prefix-matched replica unless it has this
# many more in-flight requests than the least-loaded one
PREFIX_IMBALANCE_SLACK = 4


class _TrieNode:
    __slots__ = ("children", "replica")

    def __init__(self):
        self.children: dict[str, _TrieNode] = {}
        self.replica: str | None = None


class PrefixTree:
    """Character-granularity prefix → replica map with bounded depth.

    (reference capability: prefix_aware/prefix_tree.py — theirs is a
    tenant-aware radix tree with eviction; ours tracks the latest replica to
    serve each prefix, depth-capped so memory stays bounded.)"""

    def __init__(self, max_depth: int = 256, max_nodes: int = 200_000):
        self.root = _TrieNode()
        self.max_depth = max_depth
        self.max_nodes = max_nodes
        self._node_count = 0
        self._lock = threading.Lock()

    def insert(self, text: str, replica: str) -> None:
        with self._lock:
            if self._node_count >= self.max_nodes:
                # coarse eviction: reset — stickiness is a performance hint,
                # and the hot prefixes repopulate within a few requests
                # (reference has per-tenant LRU eviction; bounded > fancy)
                self.root = _TrieNode()
                self._node_count = 0
            node = self.root
            for ch in text[: self.max_depth]:
                child = node.children.get(ch)
                if child is None:
                    child = node.children[ch] = _TrieNode()
                    self._node_count += 1
                node = child
                node.replica = replica

    def match(self, text: str) -> tuple[int, str | None]:
        """(match_length, replica that served the longest known prefix)."""
        with self._lock:
            node = self.root
            best: str | None = None
            depth = 0
            for ch in text[: self.max_depth]:
                node = node.children.get(ch)
                if node is None:
                    break
                depth += 1
                if node.replica is not None:
                    best = node.replica
            return depth, best

    def drop_replica(self, replica: str) -> None:
        """Forget a dead replica everywhere (lazy: clear markers)."""
        with self._lock:
            stack = [self.root]
            while stack:
                node = stack.pop()
                if node.replica == replica:
                    node.replica = None
                stack.extend(node.children.values())


def _route_counter():
    from ray_tpu_torch.util import metrics as met

    return met.get_or_create(
        met.Counter, "ray_tpu_serve_router_prefix_route_total",
        "prefix-aware routing outcomes (sticky = prefix-matched replica "
        "chosen, fallback = pow2 despite a hint, no_hint = no prompt)",
        tag_keys=("outcome",))


class PrefixAwarePolicy:
    """Replica-choice policy layered over the handle's in-flight counts."""

    def __init__(self):
        self.tree = PrefixTree()
        self._counter = None  # resolved lazily; registry-staleness checked

    def _count(self, outcome: str) -> None:
        from ray_tpu_torch.serve import request_context as rc
        from ray_tpu_torch.util import metrics as met

        if not rc.metrics_enabled():
            return
        # cache the counter on the policy: _count runs on the router-pick
        # hot path, where get_or_create's two global locks per pick would
        # serialize concurrent proxies (same registry-aware staleness check
        # as request_context.phase_observer)
        c = self._counter
        if c is None or met._registry.get(c.name) is not c:
            c = self._counter = _route_counter()
        c.inc(tags={"outcome": outcome})

    def pick(self, replicas: list[str], inflight: dict, hint: str | None,
             pow2_pick) -> str:
        if hint:
            depth, sticky = self.tree.match(hint)
            if sticky is not None and sticky in replicas and depth >= 4:
                least = min((inflight.get(r, 0) for r in replicas), default=0)
                if inflight.get(sticky, 0) <= least + PREFIX_IMBALANCE_SLACK:
                    self.tree.insert(hint, sticky)
                    self._count("sticky")
                    return sticky
        choice = pow2_pick()
        if hint:
            self.tree.insert(hint, choice)
        self._count("fallback" if hint else "no_hint")
        return choice

    def on_replica_dead(self, replica: str) -> None:
        self.tree.drop_replica(replica)
