"""The port's request cancellation, deadlines and overload shedding against
the JAX package's.

Twins of tests/test_serve_cancellation.py. The engine cases run
``TPUEngine`` and ``LLMEngine(device="cpu")`` on the same weights
(converted from the JAX package's f32 init) and compare what each
observes: tokens before the abort or deadline, exception class, the pool
restored, the abort count. The Serve cases run each scenario through both
runtimes' Serve (``http_port=0``) and compare statuses, headers and bodies.
"""

from __future__ import annotations

import http.client
import json
import pickle
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_twins import same, serve_of, start_sessions, stop_sessions, sub

TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
            d_ff=128, max_seq_len=128, remat=False)
PAGED = dict(max_slots=2, max_len=64, min_bucket=8, kv_layout="paged",
             page_size=8)


@pytest.fixture(scope="module")
def engines():
    """Build (jax_engine, port_engine) pairs on the same f32 weights."""
    from ray_tpu.llm.engine import TPUEngine
    from ray_tpu.models import transformer as jtransformer
    from ray_tpu.models.transformer import TransformerConfig as JConfig
    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.models import convert
    from ray_tpu_torch.models.transformer import TransformerConfig

    jcfg = JConfig(**TINY, dtype=jnp.float32)
    jparams = jtransformer.init(jax.random.PRNGKey(0), jcfg)
    tcfg = TransformerConfig(**TINY, dtype=torch.float32)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")

    def make():
        return (TPUEngine(jcfg, jparams, **PAGED),
                LLMEngine(tcfg, tparams, device="cpu", **PAGED))

    return make


def _sp(pkg, **kw):
    mod = "ray_tpu.llm.engine" if pkg == "jax" else "ray_tpu_torch.llm.engine"
    import importlib

    return importlib.import_module(mod).SamplingParams(**kw)


def _exc(pkg, name):
    import importlib

    return getattr(importlib.import_module(
        "ray_tpu.exceptions" if pkg == "jax" else "ray_tpu_torch.exceptions"),
        name)


def _wait_pool_restored(eng, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = eng.stats()
        if (st["free_slots"] == st["max_slots"]
                and st["free_pages"] == st["num_pages"] - 1):
            return st
        time.sleep(0.02)
    raise AssertionError(f"pool not restored: {eng.stats()}")


def _both(engines, case):
    """case(pkg, engine) for the JAX package's engine and the port's."""
    out = []
    for pkg, eng in zip(("jax", "port"), engines()):
        try:
            out.append(case(pkg, eng))
        finally:
            eng.shutdown()
    assert out[0] == out[1], out
    return out[0]


# ------------------------------------------------------------------ engine


def test_engine_abort_reclaims_mid_stream(engines):
    def case(pkg, eng):
        # paced, so the abort lands before the 48 tokens are decoded even
        # when the scheduler thread outruns this one (a loaded machine)
        _paced(eng)
        req = eng.submit([1, 2, 3, 4], _sp(pkg, max_tokens=48))
        it = iter(req)
        first = next(it)  # a decode step has run: the slot is bound
        eng.abort_request(req.rid)
        with pytest.raises(_exc(pkg, "RequestCancelledError")):
            for _ in it:
                pass
        st = _wait_pool_restored(eng)
        # the engine keeps serving after an abort
        after = list(eng.submit([5, 6, 7], _sp(pkg, max_tokens=4)))
        return first, st["aborts"], after

    first, aborts, after = _both(engines, case)
    assert aborts == 1 and len(after) == 4


def _paced(eng, seconds: float = 0.01):
    """Each scheduler pass of `eng` waits `seconds` first (both engines
    sweep deadlines at the top of a pass): on the CPU the port's tiny f32
    engine would otherwise decode 56 tokens before a 0.3 s deadline."""
    sweep = eng._expire_deadlines

    def paced(*args):
        time.sleep(seconds)
        return sweep(*args)

    eng._expire_deadlines = paced
    return eng


def test_engine_deadline_expires_mid_stream(engines):
    def case(pkg, eng):
        _paced(eng)
        req = eng.submit([1, 2, 3], _sp(pkg, max_tokens=56),
                         deadline_ts=time.time() + 0.3)
        toks = []
        with pytest.raises(_exc(pkg, "DeadlineExceededError")):
            for t in req:
                toks.append(t)
        _wait_pool_restored(eng)
        return len(toks) < 56  # it did not run to max_tokens

    assert _both(engines, case) is True


def test_engine_deadline_refused_at_admission(engines):
    def case(pkg, eng):
        req = eng.submit([1, 2, 3], _sp(pkg, max_tokens=8),
                         deadline_ts=time.time() - 1.0)  # already expired
        with pytest.raises(_exc(pkg, "DeadlineExceededError")):
            list(req)
        return _wait_pool_restored(eng)["aborts"]

    assert _both(engines, case) == 1


def test_engine_abort_unknown_rid_is_noop(engines):
    def case(pkg, eng):
        eng.abort_request(123456)  # never submitted: no crash
        return list(eng.submit([1, 2], _sp(pkg, max_tokens=3)))

    assert len(_both(engines, case)) == 3


# ----------------------------------------------------------- serve plumbing


def test_request_shed_error_pickles_retry_after():
    from ray_tpu.exceptions import RequestShedError as J
    from ray_tpu_torch.exceptions import RequestShedError as T

    for cls in (J, T):
        e = pickle.loads(pickle.dumps(cls("full", retry_after_s=2.5)))
        assert isinstance(e, cls) and e.retry_after_s == 2.5


def test_cancel_holder_latches_in_either_order():
    import ray_tpu
    import ray_tpu_torch

    def scn(rt):
        h = sub(rt, "serve.replica")._CancelHolder()
        fired = []
        h.register(lambda: fired.append("a"))
        h.cancel()
        first = list(fired)
        # registering after the cancel landed fires at once
        h.register(lambda: fired.append("b"))
        second = list(fired)
        h.cancel()  # idempotent
        return first, second, list(fired)

    same((ray_tpu, ray_tpu_torch), scn, (["a"], ["a", "b"], ["a", "b"]),
         serve_cleanup=False)


# -------------------------------------------------------------- end-to-end


@pytest.fixture(scope="module")
def pkgs():
    pkgs = start_sessions(num_cpus=8, num_workers=2, max_workers=10)
    yield pkgs
    stop_sessions(pkgs)


def _interruptible(serve):
    @serve.deployment
    class Interruptible:
        """Streams slowly and counts how its streams end."""

        def __init__(self):
            self.interrupted = 0
            self.completed = 0

        def stream_request(self, request: dict):
            import time as _t

            try:
                for i in range(100):
                    yield {"i": i}
                    _t.sleep(0.1)
                self.completed += 1
            except GeneratorExit:
                self.interrupted += 1
                raise

        def __call__(self, request: dict):
            return {"interrupted": self.interrupted,
                    "completed": self.completed}

    return Interruptible


def _slow_one(serve):
    @serve.deployment(max_ongoing_requests=1, max_queued_requests=0)
    class SlowOne:
        def __call__(self, request: dict):
            import time as _t

            _t.sleep(float((request.get("body") or {}).get("sleep", 1.0)))
            return {"ok": True}

    return SlowOne


def _post(port, path, body, headers=None, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    payload = json.dumps(body)
    hdrs = {"Content-Type": "application/json",
            "Content-Length": str(len(payload))}
    hdrs.update(headers or {})
    conn.request("POST", path, body=payload, headers=hdrs)
    resp = conn.getresponse()
    data = resp.read()
    out = (resp.status, dict(resp.getheaders()), data)
    conn.close()
    return out


def _poll_state(handle, pred, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    state = None
    while time.monotonic() < deadline:
        state = handle.call_sync({}, timeout_s=10.0)
        if pred(state):
            return state
        time.sleep(0.2)
    raise AssertionError(f"state never satisfied predicate: {state}")


def test_stream_cancel_via_handle(pkgs):
    def scn(rt):
        serve = serve_of(rt)
        serve.start(http_port=0)
        h = serve.run(_interruptible(serve).bind(), name="canc",
                      route_prefix="/canc")
        gen = h.options(stream=True, method_name="stream_request").remote({})
        next(iter(gen))  # the stream is live on the replica
        gen.cancel()
        return _poll_state(h, lambda s: s["interrupted"] >= 1)

    same(pkgs, scn, {"interrupted": 1, "completed": 0})


def test_http_client_disconnect_cancels_stream(pkgs):
    def scn(rt):
        serve = serve_of(rt)
        serve.start(http_port=0)
        h = serve.run(_interruptible(serve).bind(), name="disc",
                      route_prefix="/disc")
        _, port = serve.http_address()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        payload = json.dumps({})
        conn.request("POST", "/disc", body=payload,
                     headers={"Content-Type": "application/json",
                              "Accept": "text/event-stream",
                              "Content-Length": str(len(payload))})
        resp = conn.getresponse()
        status = resp.status
        resp.read1(64)  # a chunk arrived: the stream is mid-flight
        # the response holds a makefile() of the socket: close both, or
        # no FIN is sent
        resp.close()
        conn.close()
        return status, _poll_state(h, lambda s: s["interrupted"] >= 1)

    same(pkgs, scn, (200, {"interrupted": 1, "completed": 0}))


def test_overload_sheds_503_with_retry_after(pkgs):
    def scn(rt):
        serve = serve_of(rt)
        serve.start(http_port=0)
        serve.run(_slow_one(serve).bind(), name="shed", route_prefix="/shed")
        _, port = serve.http_address()
        results = []

        def hit():
            results.append(_post(port, "/shed", {"sleep": 1.5}))

        threads = [threading.Thread(target=hit) for _ in range(3)]
        for t in threads:
            t.start()
            time.sleep(0.1)  # deterministic arrival order
        for t in threads:
            t.join()
        statuses = sorted(r[0] for r in results)
        shed = next((r for r in results if r[0] == 503), None)
        err = json.loads(shed[2])["error"].lower() if shed else ""
        return (statuses[0], 503 in statuses,
                bool(shed and shed[1].get("Retry-After")),
                "shed" in err or "window" in err)

    same(pkgs, scn, (200, True, True, True))


def test_deadline_header_maps_to_504(pkgs):
    def scn(rt):
        serve = serve_of(rt)
        serve.start(http_port=0)
        serve.run(_slow_one(serve).options(max_queued_requests=-1).bind(),
                  name="dl", route_prefix="/dl")
        _, port = serve.http_address()
        t0 = time.monotonic()
        status, _, _ = _post(port, "/dl", {"sleep": 5.0},
                             headers={"x-ray-tpu-deadline-s": "0.4"})
        return status, time.monotonic() - t0 < 4.0

    same(pkgs, scn, (504, True))
