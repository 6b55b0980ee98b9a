"""The port's OOM defense, owner-death stubs and fn-store pinning against
the JAX package's.

Twins of the 13 cases of tests/test_oom_tpu_safety.py, on an unstarted
GCS of each package with fake connections: the OOM victim choice skips
accelerator workers unless the package's opt-in is set
(``oom_kill_gpu_workers`` in the port, ``oom_kill_tpu_workers`` in the JAX
package), an OOM-killed worker's accelerators are quarantined (a stale tag
does not quarantine), ``unquarantine_chips`` restores them, a pending
direct-result stub fails with OwnerDiedError when its owner dies, and
fn-store eviction keeps the blobs pending specs, lineage and actor queues
reference. The port's resource is "GPU" and a worker's grant ``gpus``
where the JAX package has "TPU" and ``tpu_chips``; each scenario runs
through both packages in turn (``torch_twins.pair``) and the two agree.
"""

from __future__ import annotations

import collections
import time

from torch_twins import env_name, is_port, pair, sub


class _FakeConn:
    """Records GCS replies/pushes without a real socket."""

    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)


def _on_gcs(tmp_path, scenario):
    """scenario(rt, gcs_module, gcs) on an unstarted GCS of each package
    with 8 CPUs and 4 accelerators, stopped after each side."""
    def scn(rt):
        mod = sub(rt, "_private.gcs")
        accel = "GPU" if is_port(rt) else "TPU"
        srv = mod.GcsServer(
            socket_path=str(tmp_path / f"{rt.__name__}.sock"),
            total_resources={"CPU": 8.0, accel: 4.0},
            spawn_worker_cb=lambda *a, **k: None)
        try:
            return scenario(rt, mod, srv)
        finally:
            try:
                srv.stop()
            except Exception:  # noqa: BLE001 — never started
                pass

    return scn


def _add_worker(rt, mod, gcs, wid, pid, chips=(), running=True):
    grant = {"gpus" if is_port(rt) else "tpu_chips": chips}
    w = mod._Worker(wid, _FakeConn(), pid, "worker", mod.DEFAULT_NODE,
                    **grant)
    if running:
        w.idle = False
        w.running_tasks["t-" + wid] = {
            "kind": "task", "task_id": "t-" + wid, "_ts": float(pid),
            "retries_used": 0, "max_retries": 3, "num_returns": 1}
    gcs.workers[wid] = w
    return w


def _optin(rt) -> str:
    return env_name(rt, "OOM_KILL_GPU_WORKERS" if is_port(rt)
                    else "OOM_KILL_TPU_WORKERS")


def test_oom_victim_prefers_chip_free_worker(tmp_path):
    def scn(rt, mod, gcs):
        _add_worker(rt, mod, gcs, "w-chip", pid=100, chips=(0, 1))
        _add_worker(rt, mod, gcs, "w-plain", pid=200)
        return gcs._pick_oom_victim()[0]

    pair(_on_gcs(tmp_path, scn), 200)


def test_oom_victim_never_tpu_worker_by_default(tmp_path):
    def scn(rt, mod, gcs):
        _add_worker(rt, mod, gcs, "w-chip", pid=100, chips=(0, 1))
        return gcs._pick_oom_victim()

    pair(_on_gcs(tmp_path, scn), None)


def test_oom_victim_tpu_worker_requires_opt_in(tmp_path, monkeypatch):
    def scn(rt, mod, gcs):
        cfg = sub(rt, "_private.ray_config").RayConfig
        _add_worker(rt, mod, gcs, "w-chip", pid=100, chips=(0, 1))
        monkeypatch.setenv(_optin(rt), "1")
        cfg.reset()
        try:
            return gcs._pick_oom_victim()[0]
        finally:
            monkeypatch.delenv(_optin(rt))
            cfg.reset()

    pair(_on_gcs(tmp_path, scn), 100)


def test_oom_killed_chip_worker_quarantines_chips(tmp_path):
    def scn(rt, mod, gcs):
        node = gcs.nodes[mod.DEFAULT_NODE]
        w = _add_worker(rt, mod, gcs, "w-chip", pid=100, chips=(0, 1))
        node.chip_pool = [2, 3]  # 0,1 are held by the worker
        w.oom_why = "killed: host memory over threshold"
        w.oom_ts = time.monotonic()
        gcs._on_worker_death("w-chip")
        # wedge-suspect accelerators withheld
        return sorted(node.quarantined_chips), sorted(node.chip_pool)

    pair(_on_gcs(tmp_path, scn), ([0, 1], [2, 3]))


def test_stale_oom_tag_does_not_quarantine(tmp_path):
    """An oom_why from a kill that never landed (older than the 30 s
    freshness window) must not quarantine on an unrelated death."""
    def scn(rt, mod, gcs):
        node = gcs.nodes[mod.DEFAULT_NODE]
        w = _add_worker(rt, mod, gcs, "w-chip", pid=100, chips=(0, 1))
        node.chip_pool = [2, 3]
        w.oom_why = "killed: host memory over threshold"
        w.oom_ts = 0.0  # ancient
        gcs._on_worker_death("w-chip")
        return node.quarantined_chips, sorted(node.chip_pool)

    pair(_on_gcs(tmp_path, scn), ([], [0, 1, 2, 3]))


def test_unquarantine_chips_rpc(tmp_path):
    def scn(rt, mod, gcs):
        node = gcs.nodes[mod.DEFAULT_NODE]
        node.quarantined_chips = [0, 1, 5]
        conn = _FakeConn()
        gcs._handle(conn, {"type": "unquarantine_chips", "rid": 1,
                           "chips": [0, 5]}, None)
        out = [sorted(conn.sent[-1]["restored"]), list(node.quarantined_chips),
               0 in node.chip_pool and 5 in node.chip_pool]
        # None = restore everything
        gcs._handle(conn, {"type": "unquarantine_chips", "rid": 2}, None)
        return out + [node.quarantined_chips, 1 in node.chip_pool]

    pair(_on_gcs(tmp_path, scn), [[0, 5], [1], True, [], True])


def test_normal_chip_worker_death_returns_chips(tmp_path):
    def scn(rt, mod, gcs):
        node = gcs.nodes[mod.DEFAULT_NODE]
        _add_worker(rt, mod, gcs, "w-chip", pid=100, chips=(0, 1))
        node.chip_pool = [2, 3]
        gcs._on_worker_death("w-chip")
        return node.quarantined_chips, sorted(node.chip_pool)

    pair(_on_gcs(tmp_path, scn), ([], [0, 1, 2, 3]))


def test_quarantined_chips_in_list_nodes(tmp_path):
    def scn(rt, mod, gcs):
        gcs.nodes[mod.DEFAULT_NODE].quarantined_chips = [7]
        conn = _FakeConn()
        gcs._handle(conn, {"type": "list_nodes", "rid": 1}, None)
        return conn.sent[-1]["nodes"][0]["quarantined_chips"]

    pair(_on_gcs(tmp_path, scn), [7])


def test_owner_death_fails_pending_stub(tmp_path):
    """A will_publish promise from a process that then dies errors the stub
    (OwnerDiedError) and answers parked waiters."""
    def scn(rt, mod, gcs):
        ser = sub(rt, "_private.serialization")
        owner = _add_worker(rt, mod, gcs, "w-owner", pid=300, running=False)
        oid = "tdeadbeefr0000"
        gcs._handle(owner.conn, {"type": "will_publish", "oid": oid,
                                 "wid": "w-owner"}, "w-owner")
        out = [gcs.objects[oid]["status"], gcs.objects[oid]["pub_wid"]]
        waiter = _FakeConn()
        gcs._wait_object(waiter, {"type": "wait_object", "oid": oid,
                                  "rid": 9, "timeout": 60.0})
        out.append(len(waiter.sent))  # parked
        gcs._on_worker_death("w-owner")
        ent = gcs.objects[oid]
        err = ser.loads(ent["inline"])
        return out + [ent["status"], bool(waiter.sent),
                      isinstance(err, sub(rt, "exceptions").OwnerDiedError)]

    pair(_on_gcs(tmp_path, scn), ["pending", "w-owner", 0, "error", True,
                                   True])


def test_published_object_unaffected_by_owner_death(tmp_path):
    """Once the owner publishes, its later death must not clobber the
    value."""
    def scn(rt, mod, gcs):
        owner = _add_worker(rt, mod, gcs, "w-owner", pid=300, running=False)
        oid = "tcafef00dr0000"
        gcs._handle(owner.conn, {"type": "will_publish", "oid": oid,
                                 "wid": "w-owner"}, "w-owner")
        gcs._on_object_ready(oid, where="inline", inline=b"blob", size=4,
                             is_error=False)
        gcs._on_worker_death("w-owner")
        ent = gcs.objects[oid]
        return ent["status"] != "error", ent["inline"]

    pair(_on_gcs(tmp_path, scn), (True, b"blob"))


def test_gcs_submit_clears_stale_publish_promise(tmp_path):
    """A direct spec redirected to the GCS path drops the old owner's
    will_publish promise, so its death can't error the now-GCS-owned
    stub."""
    def scn(rt, mod, gcs):
        owner = _add_worker(rt, mod, gcs, "w-owner", pid=300, running=False)
        owner.idle = False  # not schedulable: the task stays pending
        oid = "tfeedf00dr0000"
        gcs._handle(owner.conn, {"type": "will_publish", "oid": oid,
                                 "wid": "w-owner"}, "w-owner")
        out = [gcs.objects[oid].get("pub_wid")]
        gcs._submit_task({"kind": "task", "task_id": "tfeedf00d",
                          "func": b"\x80\x04N.", "deps": [], "num_returns": 1,
                          "resources": {"CPU": 1.0}, "max_retries": 0,
                          "retries_used": 0, "name": "t", "strategy": None})
        out.append("pub_wid" in gcs.objects[oid])
        gcs._on_worker_death("w-owner")
        return out + [gcs.objects[oid]["status"]]

    pair(_on_gcs(tmp_path, scn), ["w-owner", False, "pending"])


def test_fn_eviction_pins_referenced_shas(tmp_path):
    """fn: blobs referenced by pending specs / lineage survive eviction."""
    def scn(rt, mod, gcs):
        conn = _FakeConn()
        gcs.pending_tasks.append({"kind": "task", "task_id": "tp",
                                  "func_sha": "sha-pending", "num_returns": 1})
        gcs.lineage["tl"] = {"kind": "task", "task_id": "tl",
                             "func_sha": "sha-lineage", "num_returns": 1}
        gcs.kv["fn:sha-pending"] = b"P"
        gcs.kv["fn:sha-lineage"] = b"L"
        for i in range(2048):
            gcs.kv[f"fn:bulk{i:05d}"] = b"x"
        # the overflowing put evicts the (len - 2048) oldest keys
        gcs._handle(conn, {"type": "kv_put", "rid": 1, "key": "fn:overflow",
                           "value": b"o"}, None)
        return ("fn:sha-pending" in gcs.kv, "fn:sha-lineage" in gcs.kv,
                sum(1 for k in gcs.kv if k.startswith("fn:")))

    pair(_on_gcs(tmp_path, scn), (True, True, 2048))


def test_pinned_fn_keys_cover_actor_queues(tmp_path):
    def scn(rt, mod, gcs):
        a = collections.namedtuple("A", "queue")(
            queue=collections.deque([{"func_sha": "sha-actorq"}]))
        gcs.actors["a1"] = a
        return "fn:sha-actorq" in gcs._pinned_fn_keys_locked()

    pair(_on_gcs(tmp_path, scn), True)
