"""A port actor whose constructor raises: every call on it raises
``ActorDiedError`` carrying the constructor's error (ROADMAP Queue 3 I).

The port's own behaviour, pinned here on its runtime only: the JAX
package's GCS records the creation error but never answers calls queued
before it, so its side would wait forever (ROADMAP "Deliberate
divergence"). Upstream Ray raises ``RayActorError`` whose cause is the
creation task's error.
"""

from __future__ import annotations

import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.exceptions import ActorDiedError


@pytest.fixture(scope="module")
def session():
    rt.shutdown()
    rt.init(num_cpus=4, num_workers=1, max_workers=6)
    yield
    rt.shutdown()


def _broken():
    @rt.remote
    class Broken:
        def __init__(self, why):
            raise ValueError(why)

        def ping(self):
            return "pong"

    return Broken


def _raised(ref, timeout=20.0):
    t0 = time.monotonic()
    with pytest.raises(ActorDiedError) as ei:
        rt.get(ref, timeout=timeout)
    return str(ei.value), time.monotonic() - t0


def test_calls_queued_before_the_constructor_failed_raise(session):
    a = _broken().remote("no CUDA context")
    refs = [a.ping.remote() for _ in range(3)]  # queued while pending
    for ref in refs:
        msg, took = _raised(ref)
        assert "ValueError" in msg and "no CUDA context" in msg, msg
        assert took < 10.0


def test_calls_after_the_failure_raise_with_the_cause(session):
    a = _broken().remote("bad config")
    _raised(a.ping.remote())
    msg, took = _raised(a.ping.remote())  # the actor is dead by now
    assert "ValueError" in msg and "bad config" in msg, msg
    assert took < 5.0


def test_waiting_for_readiness_raises_with_the_cause(session):
    from ray_tpu_torch._private.api import _get_worker

    a = _broken().remote("readiness")
    with pytest.raises(ActorDiedError, match="ValueError.*readiness"):
        _get_worker().wait_actor_ready(a._actor_id, timeout=20.0)


def test_a_healthy_actor_is_unaffected(session):
    @rt.remote
    class Fine:
        def ping(self):
            return "pong"

    assert rt.get(Fine.remote().ping.remote(), timeout=30.0) == "pong"
