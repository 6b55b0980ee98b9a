"""The port's twins of tests/test_kuberay.py, against ray_tpu_torch: the
KubeRay operator integration over canned k8s API responses.

(reference: autoscaler/v2/instance_manager/cloud_providers/kuberay/
cloud_provider.py — launch = worker-group `replicas` bump, terminate =
`workersToDelete` + replicas decrement, observation = pod list. These
tests drive the real request building + patch shapes + reconciler.)
"""

import json

import pytest

from ray_tpu_torch.autoscaler.kuberay import (KubeApiError, KubeRayApiClient,
                                        KubeRayNodeProvider)


class CannedTransport:
    def __init__(self, handler):
        self.handler = handler  # (method, path) -> (status, obj)
        self.requests = []

    def __call__(self, method, url, headers, body, timeout):
        path = url.split("kubernetes.test", 1)[-1]
        self.requests.append((method, path,
                              json.loads(body) if body else None, headers))
        status, obj = self.handler(method, path)
        return status, json.dumps(obj).encode()


def _cluster(replicas=1, workers_to_delete=None, with_strategy=False):
    spec = {"groupName": "tpu-workers", "replicas": replicas,
            "minReplicas": 0, "maxReplicas": 8}
    if with_strategy or workers_to_delete is not None:
        spec["scaleStrategy"] = {
            "workersToDelete": list(workers_to_delete or [])}
    return {"metadata": {"name": "demo"},
            "spec": {"workerGroupSpecs": [spec]}}


def _pod(name, group="tpu-workers", phase="Running", ready=True,
         node_type="worker", deleting=False):
    meta = {"name": name,
            "labels": {"ray.io/cluster": "demo", "ray.io/group": group,
                       "ray.io/node-type": node_type}}
    if deleting:
        meta["deletionTimestamp"] = "2026-01-01T00:00:00Z"
    return {"metadata": meta,
            "status": {"phase": phase,
                       "conditions": [{"type": "Ready",
                                       "status": "True" if ready else "False"}]}}


def _client(handler):
    t = CannedTransport(handler)
    api = KubeRayApiClient("ns1", "demo", api_server="https://kubernetes.test",
                           token_provider=lambda: "tok", transport=t)
    return api, t


def test_auth_and_paths():
    api, t = _client(lambda m, p: (200, _cluster()))
    api.get_cluster()
    method, path, _, headers = t.requests[0]
    assert (method, path) == (
        "GET", "/apis/ray.io/v1/namespaces/ns1/rayclusters/demo")
    assert headers["Authorization"] == "Bearer tok"


def test_launch_bumps_replicas():
    state = {"cluster": _cluster(replicas=2)}

    def handler(m, p):
        if m == "GET":
            return 200, state["cluster"]
        return 200, {}

    api, t = _client(handler)
    prov = KubeRayNodeProvider(api)
    nid = prov.create_node("tpu-workers", {"TPU": 4.0}, {})
    assert nid.startswith("tpu-workers-launch-")
    patch = [r for r in t.requests if r[0] == "PATCH"][0]
    assert patch[3]["Content-Type"] == "application/json-patch+json"
    assert patch[2] == [{"op": "replace",
                         "path": "/spec/workerGroupSpecs/0/replicas",
                         "value": 3}]


def test_terminate_names_pod_and_decrements():
    state = {"cluster": _cluster(replicas=3, with_strategy=True)}

    def handler(m, p):
        if m == "GET" and "rayclusters" in p:
            return 200, state["cluster"]
        if m == "GET":
            return 200, {"items": [_pod("demo-tpu-workers-abcde")]}
        return 200, {}

    api, t = _client(handler)
    prov = KubeRayNodeProvider(api)
    assert prov.non_terminated_nodes() == ["demo-tpu-workers-abcde"]
    prov.terminate_node("demo-tpu-workers-abcde")
    patch = [r for r in t.requests if r[0] == "PATCH"][0][2]
    assert patch[0]["value"] == 2  # replicas decremented
    assert patch[1]["path"] == "/spec/workerGroupSpecs/0/scaleStrategy"
    assert patch[1]["value"]["workersToDelete"] == ["demo-tpu-workers-abcde"]


def test_terminate_appends_to_existing_workers_to_delete():
    state = {"cluster": _cluster(replicas=3,
                                 workers_to_delete=["old-pod"])}

    def handler(m, p):
        if m == "GET" and "rayclusters" in p:
            return 200, state["cluster"]
        if m == "GET":
            return 200, {"items": [_pod("pod-b")]}
        return 200, {}

    api, t = _client(handler)
    prov = KubeRayNodeProvider(api)
    prov.non_terminated_nodes()
    prov.terminate_node("pod-b")
    patch = [r for r in t.requests if r[0] == "PATCH"][0][2]
    assert patch[1]["value"]["workersToDelete"] == ["old-pod", "pod-b"]


def test_pod_observation_filters():
    pods = [_pod("w-running"),
            _pod("w-done", phase="Succeeded"),
            _pod("w-dead", phase="Failed"),
            _pod("w-deleting", deleting=True),
            _pod("head-pod", node_type="head")]

    def handler(m, p):
        if "rayclusters" in p:
            return 200, _cluster()
        return 200, {"items": pods}

    api, _ = _client(handler)
    prov = KubeRayNodeProvider(api)
    assert prov.non_terminated_nodes() == ["w-running"]
    assert prov.is_ready("w-running")


def test_api_error_surfaces():
    api, _ = _client(lambda m, p: (403, {"message": "forbidden"}))
    with pytest.raises(KubeApiError, match="403"):
        api.get_cluster()


def test_reconciler_scales_through_kuberay():
    """End to end with the Autoscaler: unmet TPU demand bumps replicas;
    the 'pod' then appearing satisfies observation."""
    import itertools

    from ray_tpu_torch.autoscaler.autoscaler import Autoscaler, NodeType

    state = {"cluster": _cluster(replicas=0), "pods": []}

    def handler(m, p):
        if m == "GET" and "rayclusters" in p:
            return 200, state["cluster"]
        if m == "GET":
            return 200, {"items": state["pods"]}
        if m == "PATCH":
            return 200, {}
        return 404, {}

    api, t = _client(handler)
    prov = KubeRayNodeProvider(api)

    class _StubGcs:
        def send(self, msg):
            self._last = msg

        def recv(self):
            if self._last["type"] == "autoscaler_attach":
                return {"rid": self._last["rid"], "ok": True}
            return {"rid": self._last["rid"],
                    "demand": {"available_resources": {},
                               "demands": [{"TPU": 4.0}],
                               "pg_demands": [], "node_ids": []}}

    a = Autoscaler.__new__(Autoscaler)
    a.provider = prov
    nt = NodeType(name="tpu-workers", resources={"TPU": 4.0, "CPU": 8.0},
                  labels={"ray.io/group": "tpu-workers"}, max_nodes=4)
    a.node_types = {nt.name: nt}
    a.interval_s = 0.1
    a.idle_timeout_s = 60.0
    a.node_startup_grace_s = 60.0
    a._conn = _StubGcs()
    a._rid = itertools.count(1)
    import threading

    a._rpc_lock = threading.Lock()
    a._stop = threading.Event()
    from ray_tpu_torch.autoscaler import instance_manager as im

    a._im = im.InstanceManager(im.MemoryInstanceStorage())
    a._recovered = True

    actions = a.reconcile_once()
    assert len(actions["launched"]) == 1
    patches = [r for r in t.requests if r[0] == "PATCH"]
    assert patches and patches[0][2][0]["value"] == 1  # replicas 0 → 1


def test_pending_launch_not_reaped_before_pod_appears():
    """A launch whose pod hasn't materialized must keep counting as a live
    instance — otherwise every reconcile pass re-bumps replicas (runaway
    scale-up)."""
    state = {"cluster": _cluster(replicas=0), "pods": []}

    def handler(m, p):
        if m == "GET" and "rayclusters" in p:
            return 200, state["cluster"]
        if m == "GET":
            return 200, {"items": state["pods"]}
        return 200, {}

    api, t = _client(handler)
    prov = KubeRayNodeProvider(api)
    lid = prov.create_node("tpu-workers", {"TPU": 4.0}, {})
    # no pod yet: the launch id itself is a live instance
    assert prov.non_terminated_nodes() == [lid]
    # pod materializes: it claims (retires) the pending launch
    state["pods"] = [_pod("demo-tpu-workers-xyz")]
    assert prov.non_terminated_nodes() == ["demo-tpu-workers-xyz"]
    assert prov.non_terminated_nodes() == ["demo-tpu-workers-xyz"]


def test_pending_launch_expires_after_ttl():
    state = {"cluster": _cluster(replicas=0)}

    def handler(m, p):
        if m == "GET" and "rayclusters" in p:
            return 200, state["cluster"]
        if m == "GET":
            return 200, {"items": []}
        return 200, {}

    api, _ = _client(handler)
    prov = KubeRayNodeProvider(api, launch_ttl_s=0.0)
    prov.create_node("tpu-workers", {"TPU": 4.0}, {})
    assert prov.non_terminated_nodes() == []  # expired; reconciler may retry
