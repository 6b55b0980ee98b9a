"""KubeRay-style operator integration: scale by patching the RayCluster CR.

The port's copy of ray_tpu/autoscaler/kuberay.py (it has no
accelerator-specific code).

The operator model (reference: python/ray/autoscaler/v2/instance_manager/
cloud_providers/kuberay/cloud_provider.py + autoscaler/kuberay/): the
autoscaler never creates pods itself — it LAUNCHES by bumping a worker
group's `replicas` and TERMINATES by naming pods in `workersToDelete`
(and decrementing `replicas`); the KubeRay operator reconciles the CR into
actual pods. Instances are observed by listing the cluster's pods.

Built like the reference's GCE REST client: an injectable transport +
token provider so every request/patch/observe path is testable offline
with canned API responses; production uses the in-cluster service account
against kubernetes.default.svc.
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

_SA_TOKEN = "/var/run/secrets/kubernetes.io/serviceaccount/token"  # noqa: S105
_SA_CA = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"


class KubeApiError(Exception):
    def __init__(self, status: int, message: str):
        self.status = status
        self.message = message
        super().__init__(f"kubernetes API error {status}: {message}")


def _default_transport(method: str, url: str, headers: Dict[str, str],
                       body: Optional[bytes], timeout: float):
    import ssl

    ctx = ssl.create_default_context(cafile=_SA_CA)
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout, context=ctx) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def serviceaccount_token() -> str:
    with open(_SA_TOKEN) as f:
        return f.read().strip()


class KubeRayApiClient:
    """Minimal k8s API client for the two objects the provider touches:
    the RayCluster custom resource and the cluster's pods."""

    def __init__(self, namespace: str, cluster_name: str, *,
                 api_server: str = "https://kubernetes.default.svc",
                 token_provider: Callable[[], str] = serviceaccount_token,
                 transport=_default_transport, timeout_s: float = 15.0):
        self.namespace = namespace
        self.cluster_name = cluster_name
        self.api_server = api_server.rstrip("/")
        self.token_provider = token_provider
        self.transport = transport
        self.timeout_s = timeout_s

    def _call(self, method: str, path: str, body: Optional[dict] = None,
              content_type: str = "application/json") -> dict:
        headers = {"Authorization": f"Bearer {self.token_provider()}",
                   "Content-Type": content_type,
                   "Accept": "application/json"}
        payload = json.dumps(body).encode() if body is not None else None
        status, data = self.transport(method, self.api_server + path,
                                      headers, payload, self.timeout_s)
        if not 200 <= status < 300:
            try:
                msg = json.loads(data).get("message", "")
            except Exception:
                msg = (data or b"")[:200].decode("utf-8", "replace")
            raise KubeApiError(status, msg)
        return json.loads(data or b"{}")

    def get_cluster(self) -> dict:
        return self._call(
            "GET", f"/apis/ray.io/v1/namespaces/{self.namespace}"
                   f"/rayclusters/{self.cluster_name}")

    def patch_cluster(self, patch: list) -> dict:
        """RFC-6902 JSON-patch on the RayCluster CR — the same mechanism
        the reference uses for replicas/workersToDelete updates."""
        return self._call(
            "PATCH", f"/apis/ray.io/v1/namespaces/{self.namespace}"
                     f"/rayclusters/{self.cluster_name}",
            body=patch, content_type="application/json-patch+json")

    def list_pods(self) -> List[dict]:
        sel = f"ray.io/cluster={self.cluster_name}"
        out = self._call(
            "GET", f"/api/v1/namespaces/{self.namespace}/pods"
                   f"?labelSelector={sel}")
        return out.get("items", [])


def _group_index(cluster: dict, group_name: str) -> int:
    groups = cluster["spec"].get("workerGroupSpecs", [])
    for i, g in enumerate(groups):
        if g.get("groupName") == group_name:
            return i
    raise KeyError(f"worker group {group_name!r} not in RayCluster "
                   f"{[g.get('groupName') for g in groups]}")


class KubeRayNodeProvider(NodeProvider):
    """NodeProvider over the operator contract: launch = replicas+1,
    terminate = workersToDelete + replicas-1, observe = pod list."""

    def __init__(self, api: KubeRayApiClient,
                 default_group: str = "workergroup",
                 launch_ttl_s: float = 600.0):
        self.api = api
        self.default_group = default_group
        self.launch_ttl_s = launch_ttl_s
        self._pod_groups: Dict[str, str] = {}  # pod name → group
        # launch ids whose pod hasn't materialized yet: they must keep
        # appearing in non_terminated_nodes or the reconciler would reap
        # the "instance" and re-bump replicas every pass (runaway scale-up)
        self._pending: Dict[str, tuple] = {}   # launch id → (group, ts)
        self._seen_pods: set = set()
        self._pods_cache: List[dict] = []
        self._pods_fetched_at = float("-inf")

    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> str:
        group = labels.get("ray.io/group") or node_type or self.default_group
        cluster = self.api.get_cluster()
        i = _group_index(cluster, group)
        spec = cluster["spec"]["workerGroupSpecs"][i]
        replicas = int(spec.get("replicas") or 0)
        self.api.patch_cluster([{
            "op": "replace",
            "path": f"/spec/workerGroupSpecs/{i}/replicas",
            "value": replicas + 1,
        }])
        # the operator chooses the pod name; return a synthetic launch id
        # tracked as pending until a new pod of the group claims it
        # (reference: launch requests are group-granular)
        lid = f"{group}-launch-{replicas + 1}-{int(time.time() * 1e3)}"
        self._pending[lid] = (group, time.monotonic())
        return lid

    def terminate_node(self, node_id: str) -> None:
        """node_id is a POD NAME (as observed); launch ids that never
        materialized terminate by replica decrement alone."""
        self._pending.pop(node_id, None)
        group = self._pod_groups.get(node_id)
        if group is None and "-launch-" in node_id:
            group = node_id.split("-launch-")[0]
        if group is None:
            # unseen pod (e.g. provider restarted): resolve its group from
            # the live pod labels — decrementing a guessed group would
            # shrink the WRONG worker group while the operator respawns
            # the named pod
            self.non_terminated_nodes()
            group = self._pod_groups.get(node_id)
        if group is None:
            raise KubeApiError(
                404, f"cannot terminate {node_id!r}: pod not found in "
                     f"cluster {self.api.cluster_name!r} (group unknown)")
        cluster = self.api.get_cluster()
        i = _group_index(cluster, group)
        spec = cluster["spec"]["workerGroupSpecs"][i]
        replicas = max(0, int(spec.get("replicas") or 0) - 1)
        patch = [{
            "op": "replace",
            "path": f"/spec/workerGroupSpecs/{i}/replicas",
            "value": replicas,
        }]
        if "-launch-" not in node_id:
            existing = (spec.get("scaleStrategy") or {}).get(
                "workersToDelete") or []
            patch.append({
                "op": "replace" if "scaleStrategy" in spec else "add",
                "path": f"/spec/workerGroupSpecs/{i}/scaleStrategy",
                "value": {"workersToDelete": list(existing) + [node_id]},
            })
        self.api.patch_cluster(patch)

    def non_terminated_nodes(self) -> List[str]:
        out = []
        self._pods_cache = self.api.list_pods()
        self._pods_fetched_at = time.monotonic()
        for pod in self._pods_cache:
            meta = pod.get("metadata", {})
            if meta.get("deletionTimestamp"):
                continue
            phase = pod.get("status", {}).get("phase")
            if phase in ("Succeeded", "Failed"):
                continue
            if meta.get("labels", {}).get("ray.io/node-type") == "head":
                continue  # the head is not an autoscaled instance
            name = meta.get("name", "")
            group = meta.get("labels", {}).get("ray.io/group",
                                               self.default_group)
            self._pod_groups[name] = group
            if name not in self._seen_pods:
                self._seen_pods.add(name)
                # a NEW pod claims (retires) the oldest pending launch of
                # its group — the pod name takes over as the instance id
                for lid, (g, ts) in sorted(self._pending.items(),
                                           key=lambda kv: kv[1][1]):
                    if g == group:
                        del self._pending[lid]
                        break
            out.append(name)
        # pending launches count as live instances until they materialize
        # or expire (operator wedged / quota: stop waiting after the TTL
        # so the reconciler can retry)
        now = time.monotonic()
        expired = [lid for lid, v in self._pending.items()
                   if now - v[1] >= self.launch_ttl_s]
        for lid in expired:
            # roll the replica bump back, or every expiry would leak one
            # replica the operator eventually materializes as an extra pod
            try:
                self.terminate_node(lid)
            except Exception:
                self._pending.pop(lid, None)  # give up; retried next pass
        return out + list(self._pending)

    def is_ready(self, node_id: str) -> bool:
        # served from the last pod listing (refreshed at most once per
        # second): per-node API calls would make each reconcile pass
        # O(pods) identical list requests
        now = time.monotonic()
        if now - self._pods_fetched_at > 1.0:
            self._pods_cache = self.api.list_pods()
            self._pods_fetched_at = now
        for pod in self._pods_cache:
            if pod.get("metadata", {}).get("name") != node_id:
                continue
            for cond in pod.get("status", {}).get("conditions", []):
                if cond.get("type") == "Ready":
                    return cond.get("status") == "True"
        return False

    def node_joined(self, node_id: str, gcs_node_ids) -> bool:
        """KubeRay pods self-join with host-id == pod name (the startup
        command passes --host-id $POD_NAME)."""
        return any(str(g) == node_id or str(g).startswith(node_id + "-")
                   for g in gcs_node_ids)
