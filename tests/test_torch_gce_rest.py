"""The port's twins of tests/test_gce_rest.py: the GCE REST client against
canned responses, the reference's over tpu.googleapis.com v2 TPU nodes and
the port's over compute.googleapis.com v1 A3 instances.

Each twin drives the same scenario through both clients (the reference's
`RestGceTpuApi`, the port's `RestGceGpuApi`), each with the responses of
its own API, and compares what matters: the requests made, the typed
error raised, the backoff drawn, the states and names read back. Then the
port's own checks: Compute's request shapes, its operation and error-reason
codes, the monitor's ``gce_gpu``/``fake_gce_gpu`` providers, and the VM
startup script, which runs the port's node agent (not the reference's
``cli start --host-id``, which its ``start`` parser does not take).
"""

from __future__ import annotations

import itertools
import json
import random
import shlex
import threading
import time

import pytest

import ray_tpu.autoscaler.gce_rest as ref_rest
import ray_tpu_torch.autoscaler.gce_rest as port_rest

_REF_ZONE = "us-central2-b"
_PORT_ZONE = "us-central1-a"
_OP = "operation-1"


class CannedTransport:
    """Scripted (status, body) responses; records every request."""

    def __init__(self, responses):
        self.responses = list(responses)
        self.requests = []

    def __call__(self, method, url, headers, body, timeout):
        self.requests.append((method, url, headers,
                              json.loads(body) if body else None))
        if not self.responses:
            raise AssertionError("transport exhausted")
        r = self.responses.pop(0)
        if isinstance(r, Exception):
            raise r
        return r


def _ok(obj=None):
    return (200, json.dumps(obj or {}).encode())


def _err(status, message, rpc="", reason=None):
    err = {"message": message, "status": rpc}
    if reason:
        err["errors"] = [{"reason": reason, "message": message}]
    return (status, json.dumps({"error": err}).encode())


class Side:
    """One package's client, errors and API response shapes."""

    def __init__(self, port: bool):
        self.port = port
        self.mod = port_rest if port else ref_rest
        self.Api = port_rest.RestGceGpuApi if port else ref_rest.RestGceTpuApi
        self.ApiError = (port_rest.ComputeApiError if port
                         else ref_rest.TpuApiError)
        self.zone = _PORT_ZONE if port else _REF_ZONE
        # what create_node is given: an A3 machine type or a TPU type
        self.unit = "a3-highgpu-8g" if port else "v4-8"
        # the port's client takes a boot image and has no default for it
        self.need = {"source_image": "img/x"} if port else {}

    def make(self, **kw):
        return self.Api("proj", self.zone, **{**self.need, **kw})

    def api(self, responses, **kw):
        t = CannedTransport(responses)
        kw.setdefault("token_provider", lambda: "tok")
        kw.setdefault("backoff_s", 0.0)
        return self.make(transport=t, **kw), t

    def state(self, s):
        """A get's body in the reference's node states, mapped to the
        Compute instance status that means the same."""
        if not self.port:
            return _ok({"state": s})
        return _ok({"status": {"READY": "RUNNING", "REPAIRING": "REPAIRING",
                               "PREEMPTED": "TERMINATED",
                               "CREATING": "PROVISIONING"}[s]})

    def op(self, done=False, error=None):
        """A long-running operation, running or done (with an error: a
        stockout in the API's own words)."""
        if not self.port:
            op = {"name": f"projects/p/locations/z/operations/{_OP}"}
            if done:
                op["done"] = True
                op["error" if error else "response"] = (
                    {"code": 8, "message": "no capacity"} if error else {})
            return _ok(op)
        op = {"name": _OP, "status": "DONE" if done else "RUNNING"}
        if error:
            op["error"] = {"errors": [{
                "code": "ZONE_RESOURCE_POOL_EXHAUSTED",
                "message": "The zone does not have enough resources"}]}
            op["httpErrorStatusCode"] = 503
        return _ok(op)

    def page(self, items, token=None):
        """A list page: [(name, reference state)]."""
        if not self.port:
            body = {"nodes": [{"name": f"projects/p/locations/z/nodes/{n}",
                               "state": s} for n, s in items]}
        else:
            status = {"READY": "RUNNING", "PREEMPTED": "TERMINATED",
                      "CREATING": "STAGING"}
            body = {"items": [{"name": n, "status": status[s]}
                              for n, s in items]}
        if token:
            body["nextPageToken"] = token
        return _ok(body)

    def kind(self, e) -> str:
        if isinstance(e, self.mod.QuotaExceededError):
            return "quota"
        if isinstance(e, self.mod.StockoutError):
            return "stockout"
        assert type(e) is self.ApiError, type(e)
        return "api"


SIDES = (Side(False), Side(True))


def both(scenario):
    """scenario(side) on the reference and on the port; both must agree."""
    a, b = (scenario(s) for s in SIDES)
    assert a == b, (a, b)
    return a


def raised(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001 — the result is the error
        return e
    return None


def test_create_node_request_shape():
    def scn(s):
        api, t = s.api([_ok()], gcs_address="10.0.0.1:6379",
                       preemptible=True)
        api.create_node("ray-gpu-1", s.unit, {"ray.io/node-group": "gpu"})
        (method, url, headers, body), = t.requests
        script = (body["metadata"]["items"][0]["value"] if s.port
                  else body["metadata"]["startup-script"])
        sched = (body["scheduling"]["preemptible"] if s.port
                 else body["schedulingConfig"]["preemptible"])
        return (method, headers["Authorization"], body["labels"], sched,
                "10.0.0.1:6379" in script, "ray-gpu-1-w" in script)

    assert both(scn) == ("POST", "Bearer tok", {"ray-io-node-group": "gpu"},
                         True, True, True)
    api, t = SIDES[1].api([_ok()], gcs_address="10.0.0.1:6379",
                          preemptible=True, source_image="img/x")
    api.create_node("ray-gpu-1", "a3-highgpu-8g", {})
    (_, url, _, body), = t.requests
    assert url == ("https://compute.googleapis.com/compute/v1/projects/proj/"
                   "zones/us-central1-a/instances")
    assert body["name"] == "ray-gpu-1"
    assert body["machineType"] == (
        "zones/us-central1-a/machineTypes/a3-highgpu-8g")
    assert body["scheduling"] == {"preemptible": True,
                                  "onHostMaintenance": "TERMINATE",
                                  "automaticRestart": False}
    disk, = body["disks"]
    assert disk["boot"] and disk["initializeParams"]["sourceImage"] == "img/x"
    assert body["networkInterfaces"] == [
        {"network": "global/networks/default"}]
    item, = body["metadata"]["items"]
    assert item["key"] == "startup-script"
    assert "ray_tpu_torch._private.node_agent" in item["value"]


def test_retry_on_transient_then_success():
    def scn(s):
        api, t = s.api([_err(503, "unavailable"), (0, b""), _ok()])
        api.create_node("n", s.unit, {})
        return len(t.requests)

    assert both(scn) == 3  # 503, transport error, then success


def test_retry_backoff_uses_full_jitter(monkeypatch):
    """The same random.Random gives the same backoff delays on both sides:
    uniform over [0, delay) on the doubling window, capped at 30 s."""
    def scn(s):
        sleeps = []
        monkeypatch.setattr(s.mod.time, "sleep", sleeps.append)
        api, t = s.api([_err(503, "unavailable")] * 4, max_retries=3,
                       backoff_s=8.0, rng=random.Random(7))
        e = raised(lambda: api.node_state("n"))
        return s.kind(e), sleeps

    kind, sleeps = both(scn)
    assert kind == "api" and len(sleeps) == 3
    expect = random.Random(7)
    for got, delay in zip(sleeps, [8.0, 16.0, 30.0]):
        assert got == expect.uniform(0.0, delay)
        assert 0.0 <= got < delay
    assert sleeps != [8.0, 16.0, 30.0]  # the ladder itself is never used


def test_retries_exhausted_raises_classified():
    def scn(s):
        api, t = s.api([_err(503, "unavailable")] * 3, max_retries=2)
        e = raised(lambda: api.create_node("n", s.unit, {}))
        return s.kind(e), e.status, len(t.requests)

    assert both(scn) == ("api", 503, 3)


def test_token_refresh_on_401():
    def scn(s):
        tokens = iter(["stale", "fresh"])
        api, t = s.api([_err(401, "unauthorized"), s.state("READY")],
                       token_provider=lambda: next(tokens))
        return (api.node_state("n"),
                [r[2]["Authorization"] for r in t.requests])

    assert both(scn) == ("READY", ["Bearer stale", "Bearer fresh"])


def test_quota_error_mapped_without_burning_retries():
    def scn(s):
        resp = (_err(403, "Quota 'NVIDIA_H100_GPUS' exceeded. Limit: 8.0",
                     reason="quotaExceeded") if s.port else
                _err(429, "Quota exceeded for TPUS-per-project",
                     rpc="RESOURCE_EXHAUSTED"))
        api, t = s.api([resp])
        e = raised(lambda: api.create_node("n", s.unit, {}))
        return s.kind(e), type(e).cooldown_s, len(t.requests)

    # a hard no is not retried or slept on
    assert both(scn) == ("quota", 120.0, 1)


def test_stockout_error_mapped_without_burning_retries():
    def scn(s):
        api, t = s.api([_err(429, "There is no available capacity in zone "
                             f"{s.zone}", rpc="RESOURCE_EXHAUSTED")])
        e = raised(lambda: api.create_node("n", s.unit, {}))
        return s.kind(e), type(e).cooldown_s, len(t.requests)

    assert both(scn) == ("stockout", 30.0, 1)


def test_persistent_401_reports_401():
    def scn(s):
        api, _ = s.api([_err(401, "unauthorized")] * 10, max_retries=2)
        e = raised(lambda: api.node_state("n"))
        return s.kind(e), e.status

    assert both(scn) == ("api", 401)


def test_async_create_operation_failure_classified():
    """HTTP 200 insert whose operation fails with a stockout — the common
    async mode — raises the typed error; the poll reads the operation."""
    def scn(s):
        api, t = s.api([s.op(), s.op(done=True, error=True)], op_poll_s=0.0)
        e = raised(lambda: api.create_node("n", s.unit, {}))
        method, url = t.requests[1][:2]
        return s.kind(e), method, url.endswith(f"operations/{_OP}")

    assert both(scn) == ("stockout", "GET", True)
    api, t = SIDES[1].api([SIDES[1].op(), SIDES[1].op(done=True,
                                                      error=True)],
                          op_poll_s=0.0)
    raised(lambda: api.create_node("n", "a3-highgpu-8g", {}))
    assert t.requests[1][1] == (
        "https://compute.googleapis.com/compute/v1/projects/proj/zones/"
        f"us-central1-a/operations/{_OP}")


def test_async_create_operation_success():
    def scn(s):
        api, t = s.api([s.op(done=True)])
        api.create_node("n", s.unit, {})  # no raise
        return len(t.requests)

    assert both(scn) == 1


def test_async_create_still_running_after_budget_is_ok():
    def scn(s):
        api, t = s.api([s.op()] * 4, op_polls=2, op_poll_s=0.0)
        api.create_node("n", s.unit, {})  # state polling takes over
        return len(t.requests)

    assert both(scn) == 3  # insert + 2 operation polls


def test_classify_non_retryable_400():
    def scn(s):
        e = s.mod.classify_error(400, json.dumps(
            {"error": {"message": "bad machineType"}}).encode())
        return s.kind(e), e.status

    assert both(scn) == ("api", 400)


def test_delete_is_idempotent_on_404():
    def scn(s):
        api, t = s.api([_err(404, "not found")])
        api.delete_node("gone")  # no raise
        return t.requests[0][0]

    assert both(scn) == "DELETE"


def test_node_state_mapping():
    def scn(s):
        api, _ = s.api([s.state("READY"), s.state("REPAIRING"),
                        s.state("PREEMPTED"), _err(404, "nope")])
        return [api.node_state(n) for n in "abcd"]

    # repairing is still coming up; preempted/terminated VMs are dead
    assert both(scn) == ["READY", "CREATING", "ABSENT", "ABSENT"]


def test_list_nodes_pagination_and_preempted_filter():
    def scn(s):
        api, t = s.api([s.page([("ray-a", "READY"), ("ray-b", "PREEMPTED")],
                               token="t2"),
                        s.page([("ray-c", "CREATING")])])
        return api.list_nodes(), "pageToken=t2" in t.requests[1][1]

    assert both(scn) == (["ray-a", "ray-c"], True)


# -- reconciler integration: the REST errors drive the same paths the fake
# -- does, plus the launch-failure cooldown --------------------------------


class _StubGcs:
    """Stands in for the Autoscaler's GCS connection."""

    def __init__(self, demands):
        self.demands = demands

    def send(self, msg):
        self._last = msg

    def recv(self):
        t = self._last["type"]
        if t == "autoscaler_attach":
            return {"rid": self._last["rid"], "ok": True}
        return {"rid": self._last["rid"],
                "demand": {"available_resources": {}, "demands": self.demands,
                           "pg_demands": [], "node_ids": []}}


def _autoscaler(s, api):
    """An Autoscaler of `s`'s package over its GCE provider, with a stub
    GCS whose one demand fits one node of the type."""
    if s.port:
        from ray_tpu_torch.autoscaler import instance_manager as im
        from ray_tpu_torch.autoscaler.autoscaler import Autoscaler, NodeType
        from ray_tpu_torch.autoscaler.gce_gpu import GceGpuNodeProvider

        provider = GceGpuNodeProvider(api)
        nt = NodeType(name="gpu-a3-highgpu-8g",
                      resources={"GPU": 8.0, "CPU": 208.0},
                      labels={"machine_type": "a3-highgpu-8g"}, max_nodes=2)
        demand = {"GPU": 8.0}
    else:
        from ray_tpu.autoscaler import instance_manager as im
        from ray_tpu.autoscaler.autoscaler import Autoscaler, NodeType
        from ray_tpu.autoscaler.gce_tpu import GceTpuNodeProvider

        provider = GceTpuNodeProvider(api)
        nt = NodeType(name="tpu-v4-8", resources={"TPU": 4.0, "CPU": 96.0},
                      labels={"accelerator_type": "v4-8"}, max_nodes=2)
        demand = {"TPU": 4.0}
    a = Autoscaler.__new__(Autoscaler)
    a.provider = provider
    a.node_types = {nt.name: nt}
    a.interval_s = 0.1
    a.idle_timeout_s = 60.0
    a.node_startup_grace_s = 60.0
    a._conn = _StubGcs([demand])
    a._rid = itertools.count(1)
    a._rpc_lock = threading.Lock()
    a._stop = threading.Event()
    a._im = im.InstanceManager(im.MemoryInstanceStorage())
    a._recovered = True
    return a, nt.name, im


def test_reconciler_launches_through_rest_client():
    def scn(s):
        api, t = s.api([s.page([]),   # ground-truth sync list
                        _ok()])       # insert (op with no name: accepted)
        a, name, _ = _autoscaler(s, api)
        actions = a.reconcile_once()
        return (len(actions["launched"]), t.requests[1][0],
                bool(actions["launch_failures"]))

    assert both(scn) == (1, "POST", False)


def test_reconciler_stockout_cooldown_then_recovery():
    def scn(s):
        stockout = _err(429, "no available capacity",
                        rpc="RESOURCE_EXHAUSTED")
        api, t = s.api([s.page([]),   # list (sync pass 1)
                        stockout,     # insert attempt 1 (hard no, no retry)
                        s.page([])])  # list (sync pass 2, still cooling)
        a, name, im = _autoscaler(s, api)
        out = []
        actions = a.reconcile_once()
        out.append((actions["launched"], name in actions["launch_failures"],
                    a._cooling_down(name)))
        # while cooling down: no new insert is attempted
        n_before = len(t.requests)
        actions2 = a.reconcile_once()
        out.append((actions2["launched"],
                    [m for m, *_ in t.requests[n_before:]]))
        # the cooldown expires (the persisted ALLOCATION_FAILED record ages
        # out) → the next pass drops it and launches again
        for f in a._im.instances(im.ALLOCATION_FAILED):
            f.cooldown_until = 0.0
            a._im.storage.put(f.to_dict())
        t.responses.extend([s.page([]), _ok()])
        actions3 = a.reconcile_once()
        out.append((len(actions3["launched"]),
                    bool(actions3["launch_failures"])))
        return out

    assert both(scn) == [([], True, True), ([], ["GET"]), (1, False)]


def test_reconciler_quota_uses_longer_cooldown():
    def scn(s):
        quota = (_err(403, "Quota 'NVIDIA_H100_GPUS' exceeded",
                      reason="quotaExceeded") if s.port
                 else _err(403, "Quota 'TPUS' exceeded"))
        api, _ = s.api([s.page([]), quota])
        a, _name, im = _autoscaler(s, api)
        a.reconcile_once()
        f, = a._im.instances(im.ALLOCATION_FAILED)
        return f.cooldown_until - time.time() > 60  # Quota cooldown_s = 120

    assert both(scn) is True


def test_preempted_slice_reaped_and_relaunched():
    def scn(s):
        api, t = s.api([
            s.page([]),   # pass 1: sync list
            _ok(),        # pass 1: insert
            s.page([]),   # pass 2: list — the node already preempted
            _ok(),        # pass 2: insert a replacement
        ])
        a, _name, _ = _autoscaler(s, api)
        a1 = a.reconcile_once()
        a2 = a.reconcile_once()
        return len(a1["launched"]), len(a2["reaped"]), len(a2["launched"])

    # the preempted node vanished from the list; demand still unmet
    assert both(scn) == (1, 1, 1)


def test_validate_fails_loudly_without_credentials():
    def scn(s):
        def no_token():
            raise OSError("metadata server unreachable")

        api = s.make(token_provider=no_token)
        with pytest.raises(RuntimeError, match="access token.*proj") as ei:
            api.validate()
        return type(ei.value.__cause__).__name__

    assert both(scn) == "OSError"


def test_validate_passes_with_token():
    def scn(s):
        s.make(token_provider=lambda: "tok").validate()
        return True

    assert both(scn)


def _build_provider(s):
    if s.port:
        from ray_tpu_torch._private.monitor import build_provider
    else:
        from ray_tpu._private.monitor import build_provider
    return build_provider


def _kind(s):
    return "gce_gpu" if s.port else "gce_tpu"


def test_build_provider_gce_missing_keys_fails_at_startup():
    def scn(s):
        build = _build_provider(s)
        out = []
        for cfg, key in (({"zone": s.zone, **s.need}, "project"),
                         ({"project": "p", **s.need}, "zone")):
            with pytest.raises(ValueError, match=f"missing.*{key}") as ei:
                build({"provider": {"type": _kind(s), **cfg}}, "addr")
            out.append(_kind(s) in str(ei.value))
        return out

    assert both(scn) == [True, True]


def test_build_provider_gce_bad_credentials_fails_at_startup(monkeypatch):
    def scn(s):
        def no_token():
            raise OSError("metadata server unreachable")

        monkeypatch.setattr(s.mod, "metadata_token_provider", no_token)
        with pytest.raises(RuntimeError, match="access token"):
            _build_provider(s)({"provider": {"type": _kind(s), "project": "p",
                                             "zone": "z", **s.need}}, "addr")
        return True

    assert both(scn)


# -- the port's own: Compute's codes, the monitor, the startup script -------


@pytest.mark.parametrize("code,kind", [
    ("QUOTA_EXCEEDED", "quota"),
    ("ZONE_RESOURCE_POOL_EXHAUSTED", "stockout"),
    ("ZONE_RESOURCE_POOL_EXHAUSTED_WITH_DETAILS", "stockout"),
    ("RESOURCE_NOT_FOUND", "api")])
def test_operation_error_codes_classified(code, kind):
    s = SIDES[1]
    op = {"name": _OP, "status": "DONE", "httpErrorStatusCode": 403,
          "error": {"errors": [{"code": code, "message": f"{code} here"}]}}
    api, t = s.api([_ok(op)])
    e = raised(lambda: api.create_node("n", s.unit, {}))
    assert s.kind(e) == kind and e.status == 403
    assert code in e.message
    assert len(t.requests) == 1  # a finished operation is not polled


@pytest.mark.parametrize("reason,status,kind", [
    ("quotaExceeded", 403, "quota"), ("rateLimitExceeded", 403, "quota"),
    ("rateLimitExceeded", 429, "quota"), ("notFound", 404, "api")])
def test_http_error_reasons_classified(reason, status, kind):
    e = port_rest.classify_error(status, _err(status, "denied",
                                              reason=reason)[1])
    assert SIDES[1].kind(e) == kind and e.status == status


def test_list_and_state_cover_every_instance_status():
    s = SIDES[1]
    statuses = ["PROVISIONING", "STAGING", "RUNNING", "STOPPING",
                "SUSPENDING", "SUSPENDED", "REPAIRING", "STOPPED",
                "TERMINATED"]
    api, t = s.api([_ok({"items": [{"name": f"vm-{i}", "status": st}
                                   for i, st in enumerate(statuses)]})]
                   + [_ok({"status": st}) for st in statuses])
    assert api.list_nodes() == ["vm-0", "vm-1", "vm-2", "vm-6"]
    assert "maxResults=500" in t.requests[0][1]
    assert [api.node_state(f"vm-{i}") for i in range(len(statuses))] == [
        "CREATING", "CREATING", "READY", "ABSENT", "ABSENT", "ABSENT",
        "CREATING", "ABSENT", "ABSENT"]


def test_startup_script_parses_under_the_port_agent_parser():
    """The VM's startup script runs the port's node agent with the host id
    node_joined keys on. The reference's script runs `cli start --host-id`,
    which its `start` parser does not take (a deliberate divergence,
    ROADMAP.md)."""
    from ray_tpu_torch._private import node_agent
    from ray_tpu_torch.autoscaler.gce_gpu import GceGpuNodeProvider

    api = port_rest.RestGceGpuApi("p", "z", source_image="img/x",
                                  gcs_address="10.0.0.1:6379",
                                  token_provider=lambda: "tok")
    script = api.startup_script("ray--blue--gpu-a3-highgpu-8g-abc123")
    shebang, line = script.strip().splitlines()
    assert shebang == "#! /bin/bash"
    argv = shlex.split(line)
    assert argv[:3] == ["python", "-m", "ray_tpu_torch._private.node_agent"]
    args = node_agent.parser().parse_args(argv[3:])
    assert args.address == "10.0.0.1:6379"
    assert args.host_id == "ray--blue--gpu-a3-highgpu-8g-abc123-w0"
    prov = GceGpuNodeProvider(api, cluster_name="blue")
    assert prov.node_joined("ray--blue--gpu-a3-highgpu-8g-abc123",
                            [args.host_id])
    # no GCS address: no script (the reference's rule)
    assert port_rest.RestGceGpuApi(
        "p", "z", source_image="img/x").startup_script("n") == ""


@pytest.mark.parametrize("kind", ["gce_gpu", "fake_gce_gpu"])
def test_monitor_builds_the_gce_gpu_providers(kind, monkeypatch):
    from ray_tpu_torch._private.monitor import build_provider
    from ray_tpu_torch.autoscaler.gce_gpu import (FakeGceGpuApi,
                                                  GceGpuNodeProvider)

    monkeypatch.setattr(port_rest, "metadata_token_provider", lambda: "tok")
    prov = build_provider({"provider": {
        "type": kind, "project": "p", "zone": "z", "cluster_name": "blue",
        **({"source_image": "img/x", "preemptible": True}
           if kind == "gce_gpu" else {})}}, "10.0.0.1:6379")
    assert isinstance(prov, GceGpuNodeProvider)
    assert prov.cluster_name == "blue"
    if kind == "fake_gce_gpu":
        assert isinstance(prov.api, FakeGceGpuApi)
        return
    api = prov.api
    assert isinstance(api, port_rest.RestGceGpuApi)
    assert (api.project, api.zone, api.source_image, api.preemptible) == (
        "p", "z", "img/x", True)
    assert "--address 10.0.0.1:6379" in api.startup_script("n")


def test_monitor_gce_gpu_without_source_image_fails_at_startup(monkeypatch):
    """The boot image has no default: a stock image holds neither torch
    nor this repository, so its VMs' agents would never start and join."""
    from ray_tpu_torch._private.monitor import build_provider

    calls = []
    monkeypatch.setattr(port_rest, "metadata_token_provider",
                        lambda: calls.append(1) or "tok")
    with pytest.raises(ValueError, match=r"missing \['source_image'\]"):
        build_provider({"provider": {"type": "gce_gpu", "project": "p",
                                     "zone": "z"}}, "10.0.0.1:6379")
    with pytest.raises(TypeError, match="source_image"):
        port_rest.RestGceGpuApi("p", "z")
    assert not calls  # refused before any credential probe
