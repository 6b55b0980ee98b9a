"""The port's cluster event log and scheduler attribution against the JAX
package's.

Twins of the 13 cases of tests/test_cluster_events.py that need no CLI and
no dashboard: the producer ring, filtering and severity ranks, the
event-literal invariant on the port's own imports, the timeline's control
rows, actor lifecycle and node-leave events (a virtual node, and a
follower host whose agent is killed), the scheduler's explain answers,
drain attribution and pending demand in ``cluster_state``,
``state.list_events``, and events surviving a GCS restart. The CLI halves
of the explain and status cases, ``test_cli_events_filters_and_json`` and
``test_dashboard_events_and_explain_endpoints`` come with the CLI and the
dashboard (ROADMAP.md Queue 1 item 20).

Pure units run through both packages in turn (``torch_twins.pair``),
session scenarios through ``torch_twins.same`` one side after the other;
each package reads its own config flags (``RAY_TPU_*``, the port's
``RAY_TPU_TORCH_*``).
"""

from __future__ import annotations

import json
import os
import signal
import time

import pytest

from torch_twins import (env_name, is_port, pair, same, shutdown_runtimes,
                         start_sessions, sub)


@pytest.fixture
def pkgs():
    out = start_sessions(num_cpus=4, num_workers=2, max_workers=4)
    yield out
    shutdown_runtimes(out)


def _same(pkgs, scn, want=None):
    """scenario(ray_tpu), then scenario(ray_tpu_torch); both must agree."""
    return same(pkgs, scn, want, serve_cleanup=False, sequential=True)


def _rpc(rt, msg: dict) -> dict:
    return sub(rt, "_private.api")._get_worker().rpc(msg)


def _events(rt, **kw) -> list:
    msg = {"type": "list_events"}
    msg.update(kw)
    return _rpc(rt, msg)["events"]


def _wait_for_event(rt, predicate, timeout=20.0, **list_kw):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        hits = [e for e in _events(rt, **list_kw) if predicate(e)]
        if hits:
            return hits
        time.sleep(0.2)
    raise AssertionError(
        f"no matching event within {timeout}s; have "
        f"{[(e.get('etype'), e.get('message')) for e in _events(rt)]}")


def _const(rt):
    return sub(rt, "_private.constants")


def _cev(rt):
    return sub(rt, "_private.events")


def _config(rt):
    return sub(rt, "_private.ray_config").RayConfig


# ------------------------------------------------ producer ring (unit)


def test_producer_ring_bounds_and_drain_once(monkeypatch):
    def scn(rt):
        const, cev, cfg = _const(rt), _cev(rt), _config(rt)
        monkeypatch.setenv(env_name(rt, "CLUSTER_EVENTS_RING_SIZE"), "8")
        cfg.reset()
        cev.reset()
        try:
            for i in range(20):
                cev.emit_event(const.EVENT_TRAIN_ATTEMPT, message=f"e{i}",
                               attempt=i)
            out = [[r["attempt"] for r in cev.recent()],
                   [r["attempt"] for r in cev.drain()], cev.drain()]
            cev.emit_event(const.EVENT_TRAIN_ATTEMPT, attempt=99)
            out.append([r["attempt"] for r in cev.drain()])
            rec = cev.recent()[-1]
            out.append(all(f in rec for f in (
                const.EVENT_FIELD_SEQ, const.EVENT_FIELD_TS,
                const.EVENT_FIELD_TYPE, const.EVENT_FIELD_SEVERITY,
                const.EVENT_FIELD_SOURCE)))
            return out
        finally:
            monkeypatch.delenv(env_name(rt, "CLUSTER_EVENTS_RING_SIZE"))
            cfg.reset()
            cev.reset()

    # bounded to the newest ring-size records, each drained once
    pair(scn, [list(range(12, 20)), list(range(12, 20)), [], [99], True])


def test_emit_disabled_records_nothing(monkeypatch):
    def scn(rt):
        const, cev, cfg = _const(rt), _cev(rt), _config(rt)
        monkeypatch.setenv(env_name(rt, "CLUSTER_EVENTS"), "0")
        cfg.reset()
        cev.reset()
        try:
            enabled = cev.enabled()
            cev.emit_event(const.EVENT_TRAIN_ATTEMPT, attempt=1)
            return enabled, cev.recent(), cev.drain()
        finally:
            monkeypatch.delenv(env_name(rt, "CLUSTER_EVENTS"))
            cfg.reset()
            cev.reset()

    pair(scn, (False, [], []))


def test_filter_events_semantics():
    def scn(rt):
        const, cev = _const(rt), _cev(rt)

        def row(seq, sev, etype, node):
            return {const.EVENT_FIELD_SEQ: seq,
                    const.EVENT_FIELD_SEVERITY: sev,
                    const.EVENT_FIELD_TYPE: etype,
                    const.EVENT_FIELD_NODE: node}

        rows = [
            row(1, const.EVENT_SEVERITY_DEBUG, const.EVENT_LEASE_GRANT, "n0"),
            row(2, const.EVENT_SEVERITY_INFO, const.EVENT_NODE_JOIN, "n0"),
            row(3, const.EVENT_SEVERITY_WARNING, const.EVENT_NODE_DRAIN, "n1"),
            row(4, const.EVENT_SEVERITY_ERROR, const.EVENT_ACTOR_DEAD, "n1"),
            row(5, "mystery", const.EVENT_NODE_JOIN, "n2"),
        ]

        def seqs(got):
            return [r[const.EVENT_FIELD_SEQ] for r in got]

        limited = cev.filter_events(
            rows, min_severity=const.EVENT_SEVERITY_INFO, limit=2)
        out = [seqs(cev.filter_events(
                   rows, min_severity=const.EVENT_SEVERITY_WARNING)),
               seqs(cev.filter_events(rows, etype=const.EVENT_NODE_JOIN)),
               seqs(cev.filter_events(rows, node="n1")),
               seqs(cev.filter_events(rows, after_seq=3)),
               seqs(limited)]
        # filter output is copies, not aliases into the ring
        limited[0]["mutated"] = True
        out.append("mutated" in rows[3])
        return out

    pair(scn, [[3, 4, 5], [2, 5], [3, 4], [4, 5], [4, 5], False])


def test_severity_rank_ordering():
    def scn(rt):
        const, cev = _const(rt), _cev(rt)
        ranks = [cev.severity_rank(s) for s in const.EVENT_SEVERITIES]
        return (ranks == sorted(ranks),
                cev.severity_rank("nonsense")
                > cev.severity_rank(const.EVENT_SEVERITY_ERROR))

    pair(scn, (True, True))


def test_event_literal_checker_flags_respelled_types(tmp_path):
    """The graft_check invariant: event-type strings at emit sites outside
    constants.py are findings (plain literals and f-strings), for a
    producer importing either package's events module."""
    from tools.graft_check.checkers.event_literals import EventLiteralChecker
    from tools.graft_check.core import ParsedModule

    def scn(rt):
        root = tmp_path / rt.__name__
        root.mkdir()
        bad = root / "producer.py"
        bad.write_text(
            f"from {rt.__name__}._private.events import emit_event\n"
            "def go(kind):\n"
            "    emit_event('node" + ".join')\n"
            "    emit_event(f'node" + ".{kind}')\n"
            "    emit_event(EVENT_NODE_JOIN)\n")
        found = list(EventLiteralChecker().check_module(
            ParsedModule(str(root), str(bad))))
        # the constants module itself is exempt
        exempt = root / "_private" / "constants.py"
        exempt.parent.mkdir()
        exempt.write_text("EVENT_NODE_JOIN = 'node" + ".join'\n"
                          "def make_event(e):\n    pass\n"
                          "X = make_event('node" + ".join')\n")
        return ([f.check_id for f in found],
                list(EventLiteralChecker().check_module(
                    ParsedModule(str(root), str(exempt)))))

    pair(scn, (["event-type-literal"] * 2, []))


def test_chrome_trace_gets_ctrl_row():
    def scn(rt):
        const = _const(rt)
        te = sub(rt, "_private.task_events")
        ev = {const.EVENT_FIELD_TYPE: const.EVENT_NODE_JOIN,
              const.EVENT_FIELD_TS: time.time(),
              const.EVENT_FIELD_NODE: "node-0",
              const.EVENT_FIELD_SEVERITY: const.EVENT_SEVERITY_INFO,
              const.EVENT_FIELD_SEQ: 1,
              const.EVENT_FIELD_MESSAGE: "joined",
              const.EVENT_FIELD_SOURCE: "gcs"}
        trace = te.to_chrome_trace(te.normalize_events([dict(ev)]))
        rows = json.loads(trace)["traceEvents"]
        # events without a node land on the cluster-wide control row
        ev2 = dict(ev)
        ev2[const.EVENT_FIELD_NODE] = ""
        return ("ctrl:node-0" in trace,
                any(r.get("name") == const.EVENT_NODE_JOIN
                    and r.get("pid") == "ctrl:node-0" for r in rows),
                "ctrl:cluster" in te.to_chrome_trace(
                    te.normalize_events([ev2])))

    pair(scn, (True, True, True))


# ------------------------------------------------ live-session lifecycle


def test_actor_lifecycle_and_restart_events(pkgs):
    """A SIGKILLed worker's actor death shows up as actor.restarting with
    its death cause, then actor.alive with the restart count, then kill
    emits a terminal actor.dead — all linked by actor_id."""
    def scn(rt):
        const = _const(rt)
        joins = _wait_for_event(rt, lambda e: e["etype"] == const.EVENT_NODE_JOIN)
        out = [any(e.get("node") for e in joins)]

        @rt.remote(max_restarts=-1)
        class Phoenix:
            def pid(self):
                import os

                return os.getpid()

        a = Phoenix.options(name="phoenix").remote()
        aid = a.actor_id
        victim = rt.get(a.pid.remote(), timeout=60)
        _wait_for_event(rt, lambda e: e["etype"] == const.EVENT_ACTOR_ALIVE
                        and e.get("actor_id") == aid)
        os.kill(victim, signal.SIGKILL)
        restarting = _wait_for_event(
            rt, lambda e: e["etype"] == const.EVENT_ACTOR_RESTARTING
            and e.get("actor_id") == aid, timeout=60)[0]
        out += [restarting["severity"] == const.EVENT_SEVERITY_WARNING,
                bool(restarting.get("death_reason"))]
        revived = _wait_for_event(
            rt, lambda e: e["etype"] == const.EVENT_ACTOR_ALIVE
            and e.get("actor_id") == aid and e.get("num_restarts", 0) >= 1,
            timeout=60)[0]
        out += [rt.get(a.pid.remote(), timeout=60) != victim,
                revived["num_restarts"] >= 1]
        rt.kill(a)
        dead = _wait_for_event(rt, lambda e: e["etype"] == const.EVENT_ACTOR_DEAD
                               and e.get("actor_id") == aid, timeout=60)[0]
        out.append(dead["severity"] == const.EVENT_SEVERITY_ERROR)
        # server-side filtering: severity floor + type + newest-N limit
        warn_up = _events(rt, severity=const.EVENT_SEVERITY_WARNING)
        out.append(bool(warn_up) and all(
            e["severity"] in (const.EVENT_SEVERITY_WARNING,
                              const.EVENT_SEVERITY_ERROR) for e in warn_up))
        only_alive = _events(rt, etype=const.EVENT_ACTOR_ALIVE)
        out.append(bool(only_alive) and all(
            e["etype"] == const.EVENT_ACTOR_ALIVE for e in only_alive))
        seqs = [e["seq"] for e in _events(rt)]
        out += [len(_events(rt, limit=2)), seqs == sorted(seqs)]
        return out

    _same(pkgs, scn, [True] * 8 + [2, True])


def test_node_leave_event_names_lost_capacity(pkgs):
    """A removed virtual node, and a follower host whose agent is killed,
    each leave a node.leave warning with its reason; the port's also names
    the capacity the cluster lost."""
    def scn(rt):
        const = _const(rt)
        cluster = sub(rt, "cluster_utils").Cluster(initialize_head=False)
        nid = cluster.add_node(num_cpus=2.0)
        _wait_for_event(rt, lambda e: e["etype"] == const.EVENT_NODE_JOIN
                        and e.get("node") == nid)
        cluster.remove_node(nid)
        out = []
        for node, total in ((nid, {"CPU": 2.0}), ("host-ev", {"CPU": 1.0})):
            if node == "host-ev":
                cluster.add_host(num_cpus=1, host_id=node)
                _wait_for_event(rt, lambda e: e["etype"] == const.EVENT_NODE_JOIN
                                and e.get("node") == node)
                cluster.remove_host(node)
            left = _wait_for_event(
                rt, lambda e: e["etype"] == const.EVENT_NODE_LEAVE
                and e.get("node") == node, timeout=30)[0]
            if is_port(rt):
                assert left["lost_resources"] == total, left
            out.append((left["severity"] == const.EVENT_SEVERITY_WARNING,
                        bool(left.get("reason"))))
        return out

    _same(pkgs, scn, [(True, True), (True, True)])


# ------------------------------------------------ scheduler attribution


def test_sched_explain_pending_actor_names_every_rejection(pkgs):
    def scn(rt):
        state = sub(rt, "util.state")

        @rt.remote(num_cpus=999)
        class TooBig:
            pass

        a = TooBig.remote()
        aid = a.actor_id
        deadline = time.monotonic() + 20
        res = {}
        while time.monotonic() < deadline:
            res = state.explain(aid)
            if res.get("found") and res.get("rejections"):
                break
            time.sleep(0.2)
        alive = [n["node_id"] for n in
                 sub(rt, "_private.api")._get_worker().list_nodes()
                 if n["alive"]]
        rej = res["rejections"]
        snap = _rpc(rt, {"type": "metrics_snapshot"})["metrics"]
        out = [res.get("found"), res["kind"], res["state"],
               set(alive) <= set(rej),
               all("insufficient CPU" in rej[n] for n in alive),
               res.get("queue_wait_s", 0) > 0,
               # decision metrics fold into the GCS snapshot
               all(f"ray_tpu_sched_{m}" in snap
                   for m in ("pending", "decisions_total",
                             "decision_seconds"))]
        rt.kill(a)
        out.append(state.explain("no-such-id")["found"])
        return out

    _same(pkgs, scn, [True, "actor", "pending", True, True, True, True,
                      False])


def test_sched_explain_placed_actor_has_trace(pkgs):
    def scn(rt):
        state = sub(rt, "util.state")

        @rt.remote
        class Small:
            def ping(self):
                return 1

        a = Small.remote()
        rt.get(a.ping.remote(), timeout=60)
        res = state.explain(a.actor_id)
        trace = res["trace"]
        rt.kill(a)
        return (res["found"], res["state"], trace.get("status"),
                bool(trace.get("node")), trace.get("queue_wait_s", -1) >= 0,
                trace.get("lease_rtt_s", -1) >= 0)

    _same(pkgs, scn, (True, "alive", "created", True, True, True))


# ------------------------------------------------ surfaces


def test_status_shows_drain_reason_and_pending_demand(pkgs):
    """cluster_state carries the pending demand, list_nodes the drain's
    reason and deadline, and the drain is an event with its reason."""
    def scn(rt):
        const = _const(rt)

        @rt.remote(num_cpus=999)
        class Parked:
            pass

        a = Parked.remote()
        w = sub(rt, "_private.api")._get_worker()
        nid = w.list_nodes()[0]["node_id"]
        r = _rpc(rt, {"type": "node_drain", "node_id": nid,
                      "reason": "maintenance window", "grace_s": 120.0})
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            cs = rt.cluster_state()
            if cs["pending_demand"]["actor_creations"] >= 1:
                break
            time.sleep(0.2)
        row = next(n for n in w.list_nodes() if n["node_id"] == nid)
        drained = _wait_for_event(
            rt, lambda e: e["etype"] == const.EVENT_NODE_DRAIN
            and e.get("node") == nid)[0]
        rt.kill(a)
        return (r["ok"], cs["pending_demand"]["actor_creations"] >= 1,
                row["draining"], row["drain_reason"],
                bool(row["drain_deadline"])
                and row["drain_deadline"] > time.time(),
                drained.get("reason"))

    _same(pkgs, scn, (True, True, True, "maintenance window", True,
                      "maintenance window"))


def test_state_list_events_severity_and_limit(pkgs):
    def scn(rt):
        const, state = _const(rt), sub(rt, "util.state")

        @rt.remote
        class Noise:
            def ping(self):
                return 1

        a = Noise.remote()
        rt.get(a.ping.remote(), timeout=60)
        rt.kill(a)
        _wait_for_event(rt, lambda e: e["etype"] == const.EVENT_ACTOR_DEAD)
        rows = state.list_events()
        two = state.list_events(limit=2)
        warn = state.list_events(severity=const.EVENT_SEVERITY_WARNING)
        return (len(rows) >= 2 and all("etype" in r for r in rows),
                len(two),
                [r["seq"] for r in two] == [r["seq"] for r in rows[-2:]],
                all(r["severity"] != const.EVENT_SEVERITY_INFO for r in warn))

    _same(pkgs, scn, (True, 2, True, True))


# ------------------------------------------------ persistence


def test_events_survive_gcs_restart(tmp_path, monkeypatch):
    """With a GCS storage path, the pre-crash event history comes back
    after a restart (same seq, same cause fields), later events sequence
    after it, and DEBUG rows stay ring-only."""
    import ray_tpu
    import ray_tpu_torch

    def scn(rt):
        const = _const(rt)
        monkeypatch.setenv(env_name(rt, "GCS_STORAGE_PATH"),
                           str(tmp_path / f"{rt.__name__}.db"))
        rt.shutdown()
        rt.init(num_cpus=4, num_workers=1, max_workers=4)
        try:
            @rt.remote
            class Witness:
                def ping(self):
                    return 1

            a = Witness.remote()
            rt.get(a.ping.remote(), timeout=60)
            aid = a.actor_id
            pre = _wait_for_event(
                rt, lambda e: e["etype"] == const.EVENT_ACTOR_ALIVE
                and e.get("actor_id") == aid)[0]
            pre_rows = _events(rt)
            pre_max_seq = max(e["seq"] for e in pre_rows)
            had_debug = any(e["severity"] == const.EVENT_SEVERITY_DEBUG
                            for e in pre_rows)
            node = sub(rt, "_private.api")._node
            node.gcs.crash_for_testing()
            time.sleep(0.3)
            node.restart_gcs()
            deadline = time.time() + 15
            while time.time() < deadline:
                try:
                    if rt.cluster_resources():
                        break
                except Exception:  # noqa: BLE001 — reconnecting
                    pass
                time.sleep(0.2)
            rows = _events(rt)
            match = [e for e in rows
                     if e["etype"] == const.EVENT_ACTOR_ALIVE
                     and e.get("actor_id") == aid]
            seqs = [e["seq"] for e in rows]
            return (bool(match) and match[0]["seq"] == pre["seq"],
                    seqs == sorted(seqs),
                    not had_debug or all(
                        e["severity"] != const.EVENT_SEVERITY_DEBUG
                        for e in rows if e["seq"] <= pre_max_seq))
        finally:
            rt.shutdown()
            monkeypatch.delenv(env_name(rt, "GCS_STORAGE_PATH"))

    same((ray_tpu, ray_tpu_torch), scn, (True, True, True), sequential=True,
         serve_cleanup=False)
