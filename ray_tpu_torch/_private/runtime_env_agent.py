"""Per-host runtime-env agent: a dedicated process that builds runtime
environments (pip venvs, conda prefixes) on request.

The port's copy of ray_tpu/_private/runtime_env_agent.py, run as
``python -m ray_tpu_torch._private.runtime_env_agent --socket <path>``. The
agent is hidden from every card: it builds venvs, and a CUDA context would
cost it seconds and a share of a card's memory.

(reference: python/ray/_private/runtime_env/agent/ — the raylet delegates
GetOrCreateRuntimeEnv to a per-node agent process so env creation is
deduplicated, asynchronous to scheduling, observable, and a broken env
fails fast instead of boot-looping workers.)

Here the spawners keep launching workers immediately (scheduling never
waits on pip); the worker BOOT shim asks this agent to get-or-create its
env instead of building it in-process. Concurrent workers needing the
same env share ONE build (an in-flight table, not just the file lock),
the agent caches results, and `list` exposes build status/errors to the
state API. If the agent is unreachable the shim falls back to the local
build path, so the agent is an optimization + observability layer, never
a single point of failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import traceback

from ray_tpu_torch._private import accelerators
from ray_tpu_torch._private.protocol import (ConnectionClosed,
                                             MsgConnection, connect_unix,
                                             listen_unix)

ENV_VAR = "RAY_TPU_TORCH_RENV_AGENT_SOCK"


def _build(renv: dict) -> dict:
    """Build whatever the env needs; returns {"python": interpreter}."""
    python = sys.executable
    conda_spec = renv.get("conda")
    pip_spec = renv.get("pip")
    if conda_spec and pip_spec:
        # same restriction as the reference: pip packages belong INSIDE the
        # conda spec's dependencies; two interpreters cannot both win
        raise ValueError(
            "runtime_env cannot combine 'conda' and 'pip' — put pip "
            "packages under the conda spec's dependencies instead")
    if conda_spec:
        from ray_tpu_torch._private.runtime_env_conda import ensure_conda_env

        python = ensure_conda_env(conda_spec)
    if pip_spec:
        from ray_tpu_torch._private.runtime_env_pip import ensure_venv

        python = ensure_venv(pip_spec)
    return {"python": python}


def _env_key(renv: dict) -> str:
    return json.dumps({k: renv.get(k) for k in ("pip", "conda")},
                      sort_keys=True)


class RuntimeEnvAgent:
    """Framed-protocol server over a unix socket; one per host."""

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        self._lock = threading.Lock()
        # key → {"state": building|ready|failed, "event", "result", "error",
        #         "refs": int}
        self._envs: dict[str, dict] = {}
        self._listener = listen_unix(socket_path)
        self._stop = False

    # ------------------------------------------------------------- server

    def serve_forever(self):
        while not self._stop:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn,
                             args=(MsgConnection(sock),),
                             daemon=True).start()

    def _serve_conn(self, conn: MsgConnection):
        try:
            while True:
                msg = conn.recv()
                try:
                    reply = self._dispatch(msg)
                except Exception as e:  # noqa: BLE001 — agent must survive
                    reply = {"ok": False,
                             "error": f"{type(e).__name__}: {e}"}
                reply["rid"] = msg.get("rid")
                conn.send(reply)
        except ConnectionClosed:
            pass

    def _dispatch(self, msg: dict) -> dict:
        t = msg.get("t")
        if t == "ping":
            return {"ok": True, "pid": os.getpid()}
        if t == "get_or_create":
            return self._get_or_create(msg.get("renv") or {})
        if t == "list":
            with self._lock:
                return {"ok": True, "envs": {
                    k: {"state": e["state"], "refs": e["refs"],
                        "error": e.get("error")}
                    for k, e in self._envs.items()}}
        if t == "shutdown":
            self._stop = True
            threading.Thread(target=self.stop, daemon=True).start()
            return {"ok": True}
        return {"ok": False, "error": f"unknown message {t!r}"}

    # -------------------------------------------------------------- logic

    def _get_or_create(self, renv: dict) -> dict:
        key = _env_key(renv)
        with self._lock:
            ent = self._envs.get(key)
            if ent is not None and ent["state"] == "failed":
                # failures don't poison the key: waiters of the original
                # build saw the error; each NEW request retries (transient
                # pip/network failures heal, like the old per-worker path)
                self._envs.pop(key)
                ent = None
            if ent is None:
                ent = {"state": "building", "event": threading.Event(),
                       "result": None, "error": None, "refs": 0}
                self._envs[key] = ent
                builder = threading.Thread(
                    target=self._run_build, args=(key, renv), daemon=True)
                builder.start()
            ent["refs"] += 1
        ent["event"].wait()
        if ent["state"] == "ready":
            return {"ok": True, **ent["result"]}
        return {"ok": False, "error": ent["error"]}

    def _run_build(self, key: str, renv: dict):
        ent = self._envs[key]
        try:
            ent["result"] = _build(renv)
            ent["state"] = "ready"
        except Exception as e:  # noqa: BLE001 — report, don't die
            ent["error"] = "".join(traceback.format_exception_only(e)).strip()
            ent["state"] = "failed"
        finally:
            ent["event"].set()

    def stop(self):
        self._stop = True
        try:
            self._listener.close()
        except OSError:
            pass
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass


class AgentHandle:
    """Lazily-started agent SUBPROCESS owned by a spawner (head node or
    follower node-agent). ensure() starts it on first use and returns the
    socket path to bake into worker envs."""

    def __init__(self, session_dir: str):
        self.socket_path = os.path.join(session_dir, "renv_agent.sock")
        self._log_path = os.path.join(session_dir, "logs",
                                      "runtime_env_agent.log")
        self.proc = None
        self._lock = threading.Lock()

    def ensure(self) -> str:
        import subprocess
        import time

        with self._lock:
            if self.proc is not None and self.proc.poll() is None:
                return self.socket_path
            env = dict(os.environ)
            accelerators.hide_gpus(env)  # the agent never touches a card
            log = open(self._log_path, "ab")
            try:
                self.proc = subprocess.Popen(
                    [sys.executable, "-m",
                     "ray_tpu_torch._private.runtime_env_agent",
                     "--socket", self.socket_path],
                    env=env, stdout=log, stderr=subprocess.STDOUT)
            finally:
                log.close()
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if os.path.exists(self.socket_path):
                    try:
                        conn = connect_unix(self.socket_path, timeout=2.0)
                        conn.send({"t": "ping", "rid": 0})
                        conn.recv()
                        conn.close()
                        return self.socket_path
                    except (OSError, ConnectionClosed):
                        pass
                time.sleep(0.05)
            # reset: a half-started process left in self.proc would make
            # every later ensure() return an unconnectable socket path
            proc, self.proc = self.proc, None
            try:
                proc.kill()
            except OSError:
                pass
            raise RuntimeError("runtime-env agent failed to come up "
                               f"(see {self._log_path})")

    def stop(self):
        with self._lock:
            if self.proc is not None and self.proc.poll() is None:
                self.proc.terminate()
                try:
                    self.proc.wait(timeout=3)
                except Exception:
                    self.proc.kill()
            self.proc = None


# ------------------------------------------------------------------ client


def get_or_create(socket_path: str, renv: dict,
                  timeout: float = 600.0) -> dict:
    """Client call used by worker_boot; raises on agent-reported failure."""
    conn = connect_unix(socket_path, timeout=5.0)
    try:
        conn.send({"t": "get_or_create", "renv": renv, "rid": 1})
        conn.sock.settimeout(timeout)
        reply = conn.recv()
        if not reply.get("ok"):
            raise RuntimeError(
                f"runtime env creation failed: {reply.get('error')}")
        return reply
    finally:
        conn.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ray_tpu_torch runtime-env-agent")
    ap.add_argument("--socket", required=True)
    args = ap.parse_args(argv)
    agent = RuntimeEnvAgent(args.socket)
    try:
        agent.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        agent.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
