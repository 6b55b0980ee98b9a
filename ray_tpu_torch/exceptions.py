"""Public exception types: the port's own copy of ray_tpu/exceptions.py
(class names and pickling kept, so a twin test compares class names)."""

from __future__ import annotations


class RayTpuError(Exception):
    pass


class RayTaskError(RayTpuError):
    """Wraps an exception raised inside a remote task/actor method.

    Re-raised at `get()` on the caller, with the remote traceback appended
    (reference: python/ray/exceptions.py RayTaskError)."""

    def __init__(self, function_name: str, traceback_str: str, cause: Exception):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(f"task {function_name} failed:\n{traceback_str}")

    def __reduce__(self):
        return (RayTaskError, (self.function_name, self.traceback_str, self.cause))


class WorkerCrashedError(RayTpuError):
    pass


class ActorDiedError(RayTpuError):
    pass


class TaskCancelledError(RayTpuError):
    """The task was cancelled via ray_tpu_torch.cancel() (reference:
    ray.exceptions.TaskCancelledError)."""


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class ObjectLostError(RayTpuError):
    pass


class OwnerDiedError(ObjectLostError):
    """The process that owned an object died before publishing/recovering it
    (reference: ray.exceptions.OwnerDiedError)."""


class PlacementGroupUnschedulableError(RayTpuError):
    pass


class RayChannelError(RayTpuError):
    """A compiled-DAG channel operation failed: peer loop/actor died, the
    channel was closed mid-execution, or the DAG was torn down (reference:
    ray.exceptions.RayChannelError)."""


class RequestCancelledError(RayTpuError):
    """The serve request was cancelled before completing: the client
    disconnected mid-stream, `DeploymentResponse.cancel()` was called, or a
    timed-out caller sent a best-effort cancel (reference:
    ray.serve.exceptions.RequestCancelledError)."""


class DeadlineExceededError(RayTpuError, TimeoutError):
    """The request's deadline expired before this hop could finish it.

    Raised per-hop: the proxy refuses dispatch, the replica refuses
    admission after queue-wait, and the engine aborts expired rows between
    decode steps — work the client will never see is never started."""


class CollectiveError(RayTpuError):
    """A host-plane collective failed because a peer rank is dead (or the
    group was already aborted by another rank's detection).

    Raised by util/collective ops well before the op's data timeout: every
    blocking wait polls peer-actor liveness alongside its data probe, so a
    SIGKILLed rank surfaces on all survivors within the configured
    detection interval instead of as an opaque TimeoutError. Carries the
    group, op seq, and the dead/suspect ranks so the train controller can
    log the failure precisely before the elastic restart."""

    def __init__(self, msg: str, *, group: str = "", seq: int | None = None,
                 dead_ranks: tuple = (), kind: str = "peer_death"):
        self.group = group
        self.seq = seq
        self.dead_ranks = tuple(dead_ranks)
        self.kind = kind
        super().__init__(msg)

    def __reduce__(self):
        return (_rebuild_collective_error,
                (self.args[0], self.group, self.seq, self.dead_ranks,
                 self.kind))


def _rebuild_collective_error(msg, group, seq, dead_ranks, kind):
    return CollectiveError(msg, group=group, seq=seq, dead_ranks=dead_ranks,
                           kind=kind)


class DataBlockError(RayTpuError):
    """A Data-plane block permanently failed after fault handling ran out.

    Raised by the streaming executor with the block id and stage name
    attached: either a SYSTEM failure (actor death / worker crash / lost
    object) exhausted its resubmission budget (``kind="system"``), or a
    UDF raised and the ``on_block_error`` policy surfaced it — directly
    under ``"raise"``, or once skipped blocks exceeded
    ``max_errored_blocks`` under ``"skip"`` (``kind="application"``)."""

    def __init__(self, msg: str, *, block_id=None, stage: str = "",
                 kind: str = "application"):
        self.block_id = block_id
        self.stage = stage
        self.kind = kind
        super().__init__(msg)

    def __reduce__(self):
        return (_rebuild_data_block_error,
                (self.args[0], self.block_id, self.stage, self.kind))


def _rebuild_data_block_error(msg, block_id, stage, kind):
    return DataBlockError(msg, block_id=block_id, stage=stage, kind=kind)


class RequestShedError(RayTpuError):
    """Admission control refused the request instead of queueing it.

    Raised when the replica's admission queue is at `max_queued_requests`
    or the router's client-side in-flight window is saturated; the HTTP
    proxy maps it to `503` + `Retry-After` (reference:
    ray.serve BackPressureError semantics)."""

    def __init__(self, msg: str = "request shed by admission control",
                 retry_after_s: float = 1.0):
        self.retry_after_s = retry_after_s
        super().__init__(msg)

    def __reduce__(self):
        return (RequestShedError, (self.args[0], self.retry_after_s))
