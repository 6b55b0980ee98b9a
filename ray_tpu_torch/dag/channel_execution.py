"""Channel-backed compiled-DAG execution plane.

The port's copy of ray_tpu/dag/channel_execution.py. Values ride the
channels through the port's serializer: a CUDA tensor a loop returns is
copied to the host on the writing side (a blocking copy, after the work on
the loop thread's current stream), so the bytes a reader sees are computed
ones, and it lands on the reading process's own card.

Steady-state compiled execution with ZERO control-plane hops per step:
`experimental_compile()` partitions the static schedule into per-actor op
lists, provisions one long-lived execution-loop task per participating
actor (submitted ONCE over the ordered actor plane — the same exec-loop
idiom as `_private/direct.py`), and allocates a seqlock `MutableShmChannel`
per cross-actor edge plus driver input/output channels. After compile,
`execute()` is one shared-memory write and `result()` one shared-memory
read; intermediates flow actor→actor through channels and never touch the
driver, the GCS, or the object store.

Lifecycle contract:
- backpressure — depth-1 mutable channels ack per hop; the driver bounds
  un-drained executions at `max_inflight_executions` by draining the
  oldest result set before admitting a new step;
- errors — a step error is serialized into the faulting op's downstream
  channels as a `_PipelineError` envelope, skips execution of every
  dependent op, and re-raises at the driver with the faulting node named;
- teardown — closing every channel (a shared-memory flag) unblocks all
  loops wherever they are; the driver then joins the loop tasks and
  unlinks every `/dev/shm` file it created;
- fallback — graphs the SPSC channel plane can't serve (task nodes,
  multi-return methods, cross-host actors, local mode) keep the existing
  per-step submit path; `CompiledDAG` records the reason;
- recovery — a dead exec loop (actor crash/SIGKILL) no longer bricks the
  DAG: when the actor has restart budget the driver waits for the core
  restart, re-provisions that actor's loop over FRESH shm channels, and
  rewires the surviving loops in band — a `_Reconfigure` sync/done barrier
  floods the data channels themselves (each loop applies the channel
  remap, forwards the marker downstream, and drains stale payloads), so
  no surviving loop is ever restarted. In-flight steps are replayed from
  the driver's retained input rows when compiled with `enable_retry=True`
  (mirroring `max_task_retries`: execution is at-least-once on surviving
  actors, results exactly-once at the driver), otherwise surfaced as
  per-step errors naming the dead node. Actors out of restart budget
  degrade the whole DAG to the submit-path fallback
  (`fallback_reason="actor_death"`) instead of killing it.

(reference: python/ray/dag/compiled_dag_node.py — do_exec_tasks per-actor
loops, ExecutableTask channel wiring, CompiledDAGRef results; Ray paper
arXiv:1712.05889 §4 motivates keeping the control plane off the ms-scale
hot path.)
"""

from __future__ import annotations

import logging
import os
import threading
import time
import traceback
from typing import Any

from ray_tpu_torch.dag.dag_node import AwaitableDAGFuture
from ray_tpu_torch.exceptions import (ActorDiedError, GetTimeoutError,
                                      RayChannelError, RayTaskError)
from ray_tpu_torch.experimental.channel.channel import ChannelClosed
from ray_tpu_torch.experimental.channel.mutable_shm import (
    MutableShmChannel, create_mutable_channel)

logger = logging.getLogger(__name__)

# actor-task method name the worker routes to actor_exec_loop() on a
# dedicated thread (never the shared exec thread — a blocked loop must not
# starve other actors hosted by the same worker process)
from ray_tpu_torch._private.constants import EXEC_LOOP_METHOD  # noqa: E402

# loops re-check liveness at this cadence while blocked on a channel: if the
# backing file vanished (driver died without teardown), they exit instead of
# polling shared memory forever
_LOOP_BLOCK_SLICE_S = 30.0
# driver-side read/write slice between loop-death / drain checks
_DRIVER_BLOCK_SLICE_S = 0.05


# actors currently occupied by a live compiled DAG's exec loop (this
# process's driver). A second compile over the same actor would queue its
# loop task behind the first forever (the GCS caps per-actor dispatch at
# max_concurrency) and hang silently — reject it at compile time instead
# (reference: Ray raises "actor is already in a compiled DAG").
_occupied_actors: set[str] = set()
_occupied_lock = threading.Lock()


def _claim_actors(aids: list) -> None:
    with _occupied_lock:
        busy = [a for a in aids if a in _occupied_actors]
        if busy:
            raise ValueError(
                f"actor {busy[0][:8]} already participates in a live "
                f"compiled DAG; teardown() that DAG first")
        _occupied_actors.update(aids)


def _release_actors(aids: list) -> None:
    with _occupied_lock:
        _occupied_actors.difference_update(aids)


class _PipelineError:
    """Error envelope flowing through channels in place of a value.

    Small and always serializable: downstream ops skip execution and
    forward it; the driver re-raises `.error` (a RayTaskError naming the
    faulting node) from `result()`."""

    def __init__(self, node_label: str, error: RayTaskError):
        self.node_label = node_label
        self.error = error

    def __repr__(self):
        return f"_PipelineError({self.node_label})"


def _task_error(label: str, exc: Exception, tb: str = "") -> _PipelineError:
    if not tb and exc is not None:
        tb = f"{type(exc).__name__}: {exc}"
    err = RayTaskError(label, tb, exc)
    try:
        from ray_tpu_torch._private import serialization as ser

        ser.dumps(err)
    except Exception:
        # unpicklable cause: keep the traceback, drop the cause (mirrors
        # the worker's execute_spec fallback)
        err = RayTaskError(label, tb or repr(exc), None)
    return _PipelineError(label, err)


class _CtrlMsg:
    """Base for control payloads that ride the data channels in place of a
    step value (the in-band recovery protocol)."""


class _Reconfigure(_CtrlMsg):
    """Rewire marker, flooded through the DAG during exec-loop recovery.

    Carries the CUMULATIVE channel remap (old shm path → replacement
    channel) so a loop that missed an earlier epoch still converges to the
    current wiring. A loop receiving one mid-step aborts the step, applies
    the remap, forwards the marker on every out-edge, then drains each
    in-edge up to its own marker — a per-channel barrier that flushes every
    stale payload without restarting the loop."""

    __slots__ = ("epoch", "remap")

    def __init__(self, epoch: int, remap: dict):
        self.epoch = epoch
        self.remap = remap  # {old /dev/shm path: MutableShmChannel}

    def __reduce__(self):
        return (_Reconfigure, (self.epoch, self.remap))

    def __repr__(self):
        return f"_Reconfigure(epoch={self.epoch}, remap={len(self.remap)})"


class _ReconfigureDone(_CtrlMsg):
    """Second barrier wave: a loop forwards this only after draining ALL
    its in-edges, so its receipt downstream proves every upstream loop has
    fully resynced — payloads after it are post-recovery data."""

    __slots__ = ("epoch",)

    def __init__(self, epoch: int):
        self.epoch = epoch

    def __reduce__(self):
        return (_ReconfigureDone, (self.epoch,))

    def __repr__(self):
        return f"_ReconfigureDone(epoch={self.epoch})"


class _ResyncSignal(Exception):
    """Raised inside a step when a channel read returns a `_Reconfigure`:
    unwinds the partial step so the loop can run the resync protocol."""

    def __init__(self, msg: _Reconfigure, channel: MutableShmChannel):
        super().__init__(f"resync epoch {msg.epoch}")
        self.msg = msg
        self.channel = channel


class _PlaneRewired(Exception):
    """Internal driver signal: a recovery completed while the caller was
    blocked on a (now replaced) channel — restart the read/write with the
    executor's fresh channel objects."""


class _PlaneDegraded(Exception):
    """Internal driver signal: the channel plane was dismantled after an
    unrecoverable actor death; `CompiledDAG` catches this and re-dispatches
    on the submit-path fallback."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class _MoreDead(Exception):
    """Internal driver signal: another exec loop died while a recovery
    barrier was in flight — abort this epoch and fold the new failure into
    the next one."""

    def __init__(self, dead: dict):
        super().__init__(f"{len(dead)} more loop death(s) during recovery")
        self.dead = dead


class _DagInput:
    """Trace-context envelope for channel payloads. The driver wraps the
    input value only when it holds an active trace AND span sampling is on;
    instrumented exec loops re-wrap their sampled intermediates so the
    context propagates DOWNSTREAM through the data channels too — actors
    past the first stage have no driver input channel, and without in-band
    forwarding their sampled steps could never join the caller's trace
    (the channel plane bypasses the submit path where `tracing.inject`
    normally rides, _private/worker.py _trace_field)."""

    __slots__ = ("value", "trace_ctx")

    def __init__(self, value, trace_ctx):
        self.value = value
        self.trace_ctx = trace_ctx

    def __reduce__(self):
        return (_DagInput, (self.value, self.trace_ctx))


# histogram bucket layout for DAG step phases: channel hops are µs-scale,
# user compute can be seconds
_STEP_BUCKETS = (50e-6, 200e-6, 1e-3, 5e-3, 25e-3, 0.1, 0.5, 2.0, 10.0)
_PHASES = (("input_wait", "input/argument wait"),
           ("compute", "user-method compute"),
           ("output_write", "output channel write"))


def _phase_histograms():
    """The three per-step phase histograms, fetched registry-aware (tests
    clear the registry; a module cache would go stale)."""
    from ray_tpu_torch.util.metrics import Histogram, get_or_create

    return tuple(
        get_or_create(Histogram, f"ray_tpu_dag_step_{phase}_seconds",
                      f"compiled-DAG per-step {desc} (channel plane)",
                      boundaries=_STEP_BUCKETS, tag_keys=("dag_id", "node"))
        for phase, desc in _PHASES)


class _LoopInstr:
    """Worker-side exec-loop instrumentation.

    Always-on path (dag_metrics): two `time.monotonic()` reads and one
    PRE-BOUND histogram observe per phase — tag merge/sort happens once at
    loop start, never per step. Every `sample`-th step additionally emits a
    full timeline span into the process task_events buffer, which the
    CoreWorker flusher already ships to the GCS; with an active trace
    context the span joins the caller's trace. When both knobs are off,
    `create` returns None and the loop takes the original untimed path —
    zero emits, zero extra allocation (the tier-1 zero-emit guard)."""

    __slots__ = ("dag_id", "sample", "_bound", "_series")

    def __init__(self, dag_id: str, sample: int, metrics_on: bool, ops):
        self.dag_id = dag_id
        self.sample = sample
        self._bound = None
        self._series: list = []  # (hist, tags) for retirement
        if metrics_on:
            hists = _phase_histograms()
            bound = []
            for op in ops:
                tags = {"dag_id": dag_id, "node": op["label"]}
                bound.append(tuple(h.bind(tags) for h in hists))
                self._series.extend((h, tags) for h in hists)
            self._bound = bound

    @classmethod
    def create(cls, plan: dict) -> "_LoopInstr | None":
        dag_id = plan.get("dag_id")
        sample = int(plan.get("sample") or 0)
        metrics_on = bool(plan.get("metrics"))
        if not dag_id or not (metrics_on or sample):
            return None
        return cls(dag_id, sample, metrics_on, plan["ops"])

    def record(self, i: int, op: dict, step: int, wait_s: float,
               compute_s: float, write_s: float, trace_ctx) -> None:
        if self._bound is not None:
            b = self._bound[i]
            b[0].observe(wait_s)
            b[1].observe(compute_s)
            b[2].observe(write_s)
        if self.sample and step % self.sample == 0:
            self._emit_span(op, step, wait_s, compute_s, write_s, trace_ctx)

    def retire(self) -> None:
        """Drop this DAG's labelsets from the registry (loop exit): dag_id
        is a short-lived tag value — per Metric.remove, leaving it would
        grow every future scrape with dead series across compiles."""
        for h, tags in self._series:
            h.remove(tags)

    def _emit_span(self, op, step, wait_s, compute_s, write_s, trace_ctx):
        from ray_tpu_torch._private import task_events

        end = time.time()
        extra = {"dag_id": self.dag_id, "node": op["label"], "seq": step,
                 "input_wait_s": round(wait_s, 9),
                 "compute_s": round(compute_s, 9),
                 "output_write_s": round(write_s, 9)}
        start = end - (wait_s + compute_s + write_s)
        if trace_ctx:
            # event kind "trace:span" so tracing.assemble() attaches the
            # step under the driver's trace tree
            task_events.emit(
                "trace:span", name=op["label"], start=start, end=end,
                trace_id=trace_ctx["trace_id"],
                span_id=os.urandom(8).hex(),
                parent_span_id=trace_ctx.get("parent_span_id", ""),
                span_kind="dag_step", ok=True, **extra)
        else:
            task_events.emit("dag:step", name=op["label"], start=start,
                             end=end, **extra)


# --------------------------------------------------------------------------
# worker side: the per-actor execution loop
# --------------------------------------------------------------------------


def _loop_read(ch: MutableShmChannel):
    """Blocking read that survives long stalls but notices a vanished
    driver: the backing /dev/shm file disappearing means nobody will ever
    close the channel properly."""
    while True:
        try:
            return ch.read(timeout=_LOOP_BLOCK_SLICE_S)
        except TimeoutError:
            if not os.path.exists(ch.path):
                raise ChannelClosed("channel file unlinked (peer gone)")


def _loop_write(ch: MutableShmChannel, payload: bytes):
    while True:
        try:
            return ch.write_serialized(payload, timeout=_LOOP_BLOCK_SLICE_S)
        except TimeoutError:
            if not os.path.exists(ch.path):
                raise ChannelClosed("channel file unlinked (peer gone)")


def _read_step(ch: MutableShmChannel):
    """Step-path read: data comes back as-is, a `_Reconfigure` aborts the
    step into resync, a stray `_ReconfigureDone` (already honored during a
    prior resync drain) is skipped."""
    while True:
        v = _loop_read(ch)
        if not isinstance(v, _CtrlMsg):
            return v
        if isinstance(v, _Reconfigure):
            raise _ResyncSignal(v, ch)
        # _ReconfigureDone from an epoch this loop already passed: discard


def _bcast(chans: list, blob: bytes) -> None:
    """Round-robin non-blocking fan-out of one control payload. MUST not
    park on a single full channel: during recovery another out-edge's
    reader may be the one whose drain unblocks this one, so every pending
    edge gets retried each round."""
    pending = list(chans)
    while pending:
        progressed = False
        for ch in list(pending):
            try:
                ch.write_serialized(blob, timeout=0)
                pending.remove(ch)
                progressed = True
            except TimeoutError:
                if not os.path.exists(ch.path):
                    raise ChannelClosed("channel file unlinked (peer gone)")
        if pending and not progressed:
            time.sleep(0.0005)


class _LoopState:
    """The exec loop's mutable wiring: op list + driver input channel,
    remappable in place by the recovery protocol (arg encodings and out
    lists are shared structures — one `apply()` rewires every reference)."""

    __slots__ = ("ops", "input", "epoch")

    def __init__(self, ops: list, input_ch):
        self.ops = ops
        self.input = input_ch
        self.epoch = 0

    def in_edges(self) -> list:
        chans = [] if self.input is None else [self.input]
        for op in self.ops:
            for enc in (*op["args"], *op["kwargs"].values()):
                if enc[0] == "chan":
                    chans.append(enc[1])
        return chans

    def out_edges(self) -> list:
        return [ch for op in self.ops for ch in op["out"]]

    def apply(self, remap: dict) -> None:
        if not remap:
            return
        if self.input is not None and self.input.path in remap:
            self.input = remap[self.input.path]
        for op in self.ops:
            op["args"] = [("chan", remap[e[1].path])
                          if e[0] == "chan" and e[1].path in remap else e
                          for e in op["args"]]
            op["kwargs"] = {k: (("chan", remap[e[1].path])
                                if e[0] == "chan" and e[1].path in remap
                                else e)
                            for k, e in op["kwargs"].items()}
            op["out"] = [remap.get(ch.path, ch) for ch in op["out"]]


def _drain_until(state: _LoopState, epoch: int, skip, want_done: bool):
    """Consume every in-edge up to its `_Reconfigure` marker (sync wave) or
    `_ReconfigureDone` (done wave), DISCARDING stale step payloads and
    stale control messages. Returns a higher-epoch `(_Reconfigure, chan)`
    if one arrives mid-drain (another failure during recovery) so the
    caller restarts the protocol, else None."""
    for ch in state.in_edges():
        if skip is not None and ch.path == skip.path:
            continue  # this edge's marker was the trigger, already consumed
        while True:
            v = _loop_read(ch)
            if isinstance(v, _Reconfigure):
                if v.epoch > epoch:
                    return v, ch
                if not want_done and v.epoch >= epoch:
                    break
                continue  # stale sync marker
            if isinstance(v, _ReconfigureDone):
                if want_done and v.epoch >= epoch:
                    break
                continue  # stale done marker
            # stale step payload from the aborted in-flight window
    return None


def _resync(state: _LoopState, rc: _Reconfigure, trigger) -> None:
    """The in-band rewire barrier, run inside the exec loop (the surviving
    loops are never restarted — the protocol rides the data channels):

    1. apply the channel remap (stale endpoints → fresh shm segments);
    2. forward the sync marker on every (post-remap) out-edge, so the
       flood reaches loops the driver cannot safely write to;
    3. drain every in-edge up to its sync marker — flushes in-flight
       payloads of the aborted step window;
    4. wait for the done marker on every in-edge (its writer finished ITS
       drain), proving no stale payload can arrive afterwards;
    5. forward the done marker downstream and resume stepping.

    A higher-epoch marker arriving mid-protocol (another actor died while
    recovering) restarts the procedure at that epoch — the marker carries
    the cumulative remap, so earlier missed epochs are covered."""
    from ray_tpu_torch._private import serialization as ser

    while True:
        state.apply(rc.remap)
        epoch = rc.epoch
        _bcast(state.out_edges(), ser.dumps(rc))
        nxt = _drain_until(state, epoch, trigger, want_done=False)
        if nxt is None:
            nxt = _drain_until(state, epoch, None, want_done=True)
        if nxt is not None:
            rc, trigger = nxt
            continue
        _bcast(state.out_edges(), ser.dumps(_ReconfigureDone(epoch)))
        state.epoch = epoch
        return


def _emit(outs: list, result, label: str):
    """Serialize once, write to every out-edge. Oversized payloads become a
    clear in-band error (the channel stays usable for the next step)."""
    from ray_tpu_torch._private import serialization as ser

    try:
        blob = ser.dumps(result)
    except Exception:
        result = _task_error(label, None, traceback.format_exc())
        blob = ser.dumps(result)
    cap = min(ch.capacity for ch in outs)
    if len(blob) > cap and type(result) is _DagInput:
        # the sampled-step trace envelope must not make a fitting
        # intermediate fail every Nth step: strip it and retry bare
        result = result.value
        blob = ser.dumps(result)
    if len(blob) > cap:
        result = _task_error(label, ValueError(
            f"DAG intermediate from {label} is {len(blob)}B, exceeding the "
            f"channel capacity {cap}B (raise channel_buffer_bytes at "
            f"experimental_compile)"))
        blob = ser.dumps(result)
    for ch in outs:
        _loop_write(ch, blob)


def _run_op(instance, op, args, kwargs, execer):
    """One method invocation; `async def` methods resolve on the actor's
    own event loop (ActorExecutor) so they share its loop-bound state, or
    on a private loop when the actor has none."""
    import inspect

    result = getattr(instance, op["method"])(*args, **kwargs)
    if inspect.iscoroutine(result):
        if execer is not None and getattr(execer, "_loop", None) is not None:
            return execer.run_coroutine_sync(result)
        import asyncio

        return asyncio.run(result)
    return result


def _materialize_args(op: dict, regs: list, inp):
    args = [_decode(e, regs, inp) for e in op["args"]]
    kwargs = {k: _decode(e, regs, inp) for k, e in op["kwargs"].items()}
    return args, kwargs


def _materialize_args_traced(op: dict, regs: list, inp):
    """Instrumented-path variant: channel args may arrive wrapped in a
    _DagInput envelope (an upstream loop forwarding the caller's trace
    context on a sampled step) — unwrap and surface the context."""
    ctx = None

    def dec(e):
        nonlocal ctx
        v = _decode(e, regs, inp)
        if type(v) is _DagInput:
            ctx = v.trace_ctx
            v = v.value
        return v

    args = [dec(e) for e in op["args"]]
    kwargs = {k: dec(e) for k, e in op["kwargs"].items()}
    return args, kwargs, ctx


def _compute_op(instance, op: dict, args, kwargs, execer):
    poisoned = next(
        (v for v in (*args, *kwargs.values())
         if isinstance(v, _PipelineError)), None)
    if poisoned is not None:
        return poisoned  # propagate, don't execute
    try:
        return _run_op(instance, op, args, kwargs, execer)
    except Exception as e:  # noqa: BLE001 — becomes in-band error
        return _task_error(op["label"], e, traceback.format_exc())


def actor_exec_loop(instance, plan: dict, _execer=None) -> dict:
    """Run inside the actor process until the driver tears the DAG down.

    `plan` (built by try_build, shipped once at compile time):
      ops:     [{method, args, kwargs, out, label}] in schedule order; arg
               encodings are ("const", v) | ("reg", i) | ("chan", ch) |
               ("input",)
      input:   driver input channel (also the pacing tick for actors whose
               ops have no channel in-edges), or None
      resync:  recovery epoch when this loop replaces one that died — the
               loop runs the rewire barrier before its first step so its
               fresh channels synchronize with the surviving loops
      dag_id / metrics / sample: instrumentation identity + knobs, stamped
               at compile time from the driver's RayConfig so workers need
               no env propagation
    """
    state = _LoopState(plan["ops"], plan.get("input"))
    instr = _LoopInstr.create(plan)
    try:
        if plan.get("resync"):
            _resync(state, _Reconfigure(int(plan["resync"]), {}), None)
        return _exec_loop_body(instance, state, instr, _execer)
    except ChannelClosed:
        return {"steps": 0, "status": "closed"}
    finally:
        if instr is not None:
            # ANY exit path (ChannelClosed or a crashed loop in a
            # still-alive actor) must drop this DAG's labelsets, or the
            # flusher keeps exporting dead per-dag_id series forever
            instr.retire()


def _exec_loop_body(instance, state: _LoopState, instr, _execer) -> dict:
    steps = 0
    try:
        while True:
            try:
                if instr is None:
                    _one_step(instance, state, _execer)
                else:
                    _one_step_traced(instance, state, instr, steps, _execer)
            except _ResyncSignal as s:
                # a neighbor died and was re-provisioned: abort the partial
                # step (its replay — or its per-step error — is the
                # driver's call), rewire, and keep looping
                _resync(state, s.msg, s.channel)
                continue
            steps += 1
    except ChannelClosed:
        return {"steps": steps, "status": "closed"}


def _one_step(instance, state: _LoopState, _execer) -> None:
    # untimed path: metrics + sampling disabled — no clock reads, no
    # emits, no extra allocation per step
    inp = _read_step(state.input) if state.input is not None else None
    if type(inp) is _DagInput:
        inp = inp.value
    regs: list[Any] = []
    for op in state.ops:
        args, kwargs = _materialize_args(op, regs, inp)
        result = _compute_op(instance, op, args, kwargs, _execer)
        regs.append(result)
        if op["out"]:
            _emit(op["out"], result, op["label"])


def _one_step_traced(instance, state: _LoopState, instr, steps,
                     _execer) -> None:
    t0 = time.monotonic()
    inp = _read_step(state.input) if state.input is not None else None
    t1 = time.monotonic()
    in_wait = t1 - t0
    trace_ctx = None
    if type(inp) is _DagInput:
        trace_ctx = inp.trace_ctx
        inp = inp.value
    regs: list[Any] = []
    sampled = instr.sample and steps % instr.sample == 0
    for i, op in enumerate(state.ops):
        # stamps chain op-to-op: t1 is the previous op's write
        # end (3 clock reads per op, not 5)
        args, kwargs, chan_ctx = _materialize_args_traced(op, regs, inp)
        op_ctx = chan_ctx or trace_ctx
        t2 = time.monotonic()
        result = _compute_op(instance, op, args, kwargs, _execer)
        t3 = time.monotonic()
        regs.append(result)
        if op["out"]:
            wire = result
            if (sampled and op_ctx is not None
                    and not isinstance(result, _PipelineError)):
                # forward the trace context downstream in-band
                # so later stages' sampled steps join the trace
                wire = _DagInput(result, op_ctx)
            _emit(op["out"], wire, op["label"])
        t4 = time.monotonic()
        # the driver-input wait is attributed to the actor's
        # first op (the read happens once per step, loop-level)
        instr.record(i, op, steps,
                     (t2 - t1) + (in_wait if i == 0 else 0.0),
                     t3 - t2, t4 - t3, op_ctx)
        t1 = t4


def _decode(enc, regs, inp):
    kind = enc[0]
    if kind == "const":
        return enc[1]
    if kind == "reg":
        return regs[enc[1]]
    if kind == "chan":
        return _read_step(enc[1])
    if kind == "input":
        return inp
    raise ValueError(f"unknown arg encoding {kind!r}")


# --------------------------------------------------------------------------
# driver side
# --------------------------------------------------------------------------


class ChannelDAGFuture(AwaitableDAGFuture):
    """Handle to one in-flight channel-plane execution. `result()` blocks,
    `done()` polls, `await` works inside a running event loop (via
    AwaitableDAGFuture). Results are delivered in submission order; each
    future caches its own row so `result()` is repeatable."""

    def __init__(self, executor: "ChannelExecutor", seq: int):
        self._ex = executor
        self._seq = seq
        self._have = False
        self._row = None
        self._fetch_lock = threading.Lock()

    def _fetch(self, timeout=None):
        # serialized: `await fut` (a default-executor thread) racing a
        # direct result() must not both _take the row — the loser would
        # see a spurious "already consumed"
        with self._fetch_lock:
            if not self._have:
                self._row = self._ex._take(self._seq, timeout)
                self._have = True
            return self._row

    def result(self, timeout: float | None = None):
        row = self._fetch(timeout)
        for v in row:
            if isinstance(v, _PipelineError):
                raise v.error
        return list(row) if self._ex._multi else row[0]

    def done(self) -> bool:
        return self._have or self._ex._done(self._seq)


class ChannelExecutor:
    """Driver endpoint of the channel plane: owns every channel (creator
    handles → unlink responsibility), the loop-task refs, and the in-order
    result drain."""

    def __init__(self, worker, plans: dict, order: list, in_chans: list,
                 out_chans: list, all_chans: list, *, max_inflight: int,
                 multi: bool, dag_id: str | None = None, sample: int = 0,
                 metrics_on: bool = False, topology: list | None = None,
                 ends: dict | None = None, buffer_bytes: int = 1 << 20,
                 enable_retry: bool = False):
        self._worker = worker
        self._plans = plans
        self._order = order  # actor ids, schedule order
        self._in_chans = in_chans
        self._out_chans = out_chans
        self._all_chans = all_chans
        self._max_inflight = max(1, int(max_inflight))
        self._multi = multi
        self._dag_id = dag_id
        self._sample = int(sample or 0)
        self.topology = list(topology or ())  # channel edges, for registry
        # ---- exec-loop recovery state -----------------------------------
        # channel endpoints by shm path ("driver" or actor id on each side):
        # recovery replaces every channel adjacent to a dead actor and must
        # know who to force-ack (dead reader) vs. where to inject markers
        self._ends: dict[str, tuple[str, str]] = dict(ends or {})
        self._buffer_bytes = int(buffer_bytes)
        self._enable_retry = bool(enable_retry)
        self._inputs: dict[int, bytes] = {}  # seq → retained input payload
        self._epoch = 0  # recovery generation (monotonic per executor)
        # cumulative remap across recoveries, collapsed transitively: a
        # loop that missed epoch N still lands on epoch N+1's channels
        self._cum_remap: dict[str, MutableShmChannel] = {}
        # replaced-but-not-yet-unlinked OLD channels, as (channel,
        # needs_marker, needs_ack) — flags decided with the endpoint
        # knowledge of the epoch that replaced them. Kept across _MoreDead-
        # aborted epochs: a survivor may still be parked on a PREVIOUS
        # epoch's abandoned edge, so every barrier pump serves the whole
        # backlog, and unlink happens only after a barrier completes.
        self._stale: list[tuple[MutableShmChannel, bool, bool]] = []
        self._degraded: str | None = None
        self.recoveries = 0
        # first-op label per actor, for error messages naming the node
        self._labels = {aid: (plans[aid]["ops"][0]["label"]
                              if plans[aid]["ops"] else f"actor:{aid[:8]}")
                        for aid in order}
        self._h_bp = None  # driver-side backpressure-drain phase histogram
        self._h_bp_src = None  # (hist, tags) for series retirement
        if metrics_on and dag_id:
            from ray_tpu_torch.util.metrics import Histogram, get_or_create

            hist = get_or_create(
                Histogram, "ray_tpu_dag_step_backpressure_drain_seconds",
                "compiled-DAG driver wait draining the oldest result at "
                "max_inflight (channel plane)",
                boundaries=_STEP_BUCKETS, tag_keys=("dag_id", "node"))
            tags = {"dag_id": dag_id, "node": "driver"}
            self._h_bp = hist.bind(tags)
            self._h_bp_src = (hist, tags)
        self._loops: dict[str, Any] = {}  # aid → loop-task ObjectRef
        self._lock = threading.Lock()
        self._submitted = 0
        self._drained = 0  # next seq to drain
        self._row: list = []  # partial output row for seq self._drained
        self._results: dict[int, list] = {}
        # fire-and-forget callers (execute() with the future discarded)
        # must not grow driver memory without bound: beyond this depth,
        # drained rows whose future was dropped are evicted oldest-first.
        # Rows with a live future are always kept — the caller can still
        # result() them.
        import weakref

        self._retain = max(2 * self._max_inflight, 32)
        self._live: "weakref.WeakValueDictionary[int, ChannelDAGFuture]" = (
            weakref.WeakValueDictionary())
        self._expired_below = 0  # seqs under this were evicted unconsumed
        # _torn is set OUTSIDE self._lock (own tiny lock for idempotency):
        # teardown must be able to abort a result()/execute() that is
        # blocked on a channel while HOLDING self._lock — those loops poll
        # _torn between read/write slices
        self._torn = False
        self._torn_lock = threading.Lock()

    # ------------------------------------------------------------- provision

    def _provision(self):
        for aid in self._order:
            # max_task_retries=0 per spec: on actor death the GCS must FAIL
            # the loop task (resolving the ref — the driver's liveness
            # signal), never requeue it on the restarted actor, where it
            # would resurrect a stale loop over dead channels and occupy
            # the concurrency slot the re-provisioned loop needs
            ref = self._worker.submit_actor_task(
                aid, EXEC_LOOP_METHOD, (self._plans[aid],), {},
                num_returns=1, max_task_retries=0)[0]
            self._loops[aid] = ref

    @property
    def stats(self) -> dict:
        return {"actors": len(self._order),
                "channels": len(self._all_chans),
                "executions_submitted": self._submitted}

    def _err(self, msg: str, node: str | None = None) -> RayChannelError:
        """Every driver-raised channel error names the dag and, when known,
        the faulting node — a bare 'torn down' is undebuggable once several
        compiled DAGs share a process."""
        where = f" (node {node})" if node else ""
        return RayChannelError(f"compiled DAG {self._dag_id}{where}: {msg}")

    # --------------------------------------------------------------- execute

    def execute(self, input_value) -> ChannelDAGFuture:
        from ray_tpu_torch._private import serialization as ser

        with self._lock:
            if self._torn:
                raise self._err("torn down")
            if self._degraded is not None:
                raise _PlaneDegraded(self._degraded)
            if self._sample and self._submitted % self._sample == 0:
                # envelope the driver's trace context only on steps the
                # loops will actually sample (their step counters advance
                # in lockstep with the submission seq) and only when a
                # trace is active; every other step rides the channel as
                # the raw value
                from ray_tpu_torch.util import tracing

                ctx = tracing.inject()
                if ctx is not None:
                    input_value = _DagInput(input_value, ctx)
            payload = ser.dumps(input_value)
            cap = min(ch.capacity for ch in self._in_chans)
            if len(payload) > cap and type(input_value) is _DagInput:
                # the trace envelope must never turn a fitting input into
                # a 1-in-N failure: drop it (losing this step's trace
                # join), keep the step
                input_value = input_value.value
                payload = ser.dumps(input_value)
            if len(payload) > cap:
                # checked BEFORE any channel write: a partial input fan-out
                # would desynchronize the actor loops
                raise ValueError(
                    f"DAG input is {len(payload)}B, exceeding the channel "
                    f"capacity {cap}B (raise channel_buffer_bytes at "
                    f"experimental_compile)")
            t_bp = None
            while self._submitted - self._drained >= self._max_inflight:
                if t_bp is None:
                    t_bp = time.monotonic()
                try:
                    self._drain_one(deadline=None)
                except _PlaneRewired:
                    continue  # recovery reset the row; re-check the window
            if t_bp is not None and self._h_bp is not None:
                self._h_bp.observe(time.monotonic() - t_bp)
            # the seq is ADMITTED (and its input retained) before the first
            # channel write: a recovery triggered mid-fan-out then treats
            # this step as in-flight — replayed (enable_retry) or failed —
            # instead of leaving the loops half-fed and desynchronized
            seq = self._submitted
            self._submitted += 1
            if self._enable_retry:
                self._inputs[seq] = payload
            fut = ChannelDAGFuture(self, seq)
            self._live[seq] = fut  # registered under the lock: eviction
            # scans _live, so the row must never look abandoned here
            try:
                for ch in self._in_chans:
                    self._write_input(ch, payload)
            except (_PlaneRewired, _PlaneDegraded):
                # the recovery replayed (or error-settled) every in-flight
                # seq — including this one — over the rewired plane; the
                # remaining fan-out writes must not run on top of that
                pass
        return fut

    def _write_input(self, ch, payload: bytes):
        # caller holds the lock. A full input channel means the pipeline is
        # backed up to the driver — drain any completed output rows while
        # waiting, or the driver (sole output consumer) deadlocks the loop
        # it is trying to feed
        while True:
            try:
                return ch.write_serialized(payload,
                                           timeout=_DRIVER_BLOCK_SLICE_S)
            except TimeoutError:
                while self._drain_one_nonblocking():
                    pass
                self._check_loops()
            except ChannelClosed as e:
                dst = self._ends.get(ch.path, ("driver", None))[1]
                node = self._labels.get(dst, dst)
                raise self._err(f"input channel closed: {e}",
                                node=node) from e

    # ----------------------------------------------------------------- drain

    def _take(self, seq: int, timeout: float | None):
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._lock:
            while seq >= self._drained:
                try:
                    self._drain_one(deadline)
                except (_PlaneRewired, _PlaneDegraded):
                    # recovery (or degrade) may have error-settled this seq
                    # already — re-check before reading again
                    continue
            row = self._results.pop(seq, None)
        if row is None:
            if seq < self._expired_below:
                raise self._err(
                    f"result for execution #{seq} expired: it stayed "
                    f"unconsumed beyond the retention window "
                    f"({self._retain} rows)")
            raise self._err(
                f"result for execution #{seq} was already consumed")
        return row

    def _done(self, seq: int) -> bool:
        # true poll: never blocks. The lock-free int read answers already-
        # drained seqs; the opportunistic drain is skipped when a blocked
        # result()/execute() holds the lock (it would block us unboundedly)
        if seq < self._drained:
            return True
        if not self._lock.acquire(blocking=False):
            return False
        try:
            while self._drain_one_nonblocking():
                pass
            return seq < self._drained
        finally:
            self._lock.release()

    def _drain_one(self, deadline):
        """Read one full output row (all output channels, fixed order) into
        the buffer. Caller holds the lock."""
        while len(self._row) < len(self._out_chans):
            ch = self._out_chans[len(self._row)]
            self._row.append(self._read_out(ch, deadline))
        self._store_row()

    def _drain_one_nonblocking(self) -> bool:
        # never blocks, never recovers: this path backs the PUBLIC done()
        # poll (and the recovery pump's own drains), so it must not call
        # _check_loops — a recovery starting inside done() would leak
        # _PlaneRewired out of a non-throwing API
        while len(self._row) < len(self._out_chans):
            ch = self._out_chans[len(self._row)]
            if not ch.poll():
                return False
            try:
                v = ch.read(timeout=0)
            except (TimeoutError, ChannelClosed):
                return False
            if isinstance(v, _CtrlMsg):
                continue  # stray marker from a completed epoch: re-poll
            if type(v) is _DagInput:
                v = v.value
            self._row.append(v)
        self._store_row()
        return True

    def _store_row(self):
        self._results[self._drained] = self._row
        self._row = []
        self._inputs.pop(self._drained, None)  # its replay window closed
        self._drained += 1
        if len(self._results) <= self._retain:
            return
        for seq in list(self._results):  # insertion order = seq order
            if len(self._results) <= self._retain:
                break
            if seq in self._live:
                continue  # future still held: the caller can result() it
            self._results.pop(seq)
            self._expired_below = max(self._expired_below, seq + 1)

    def _read_out(self, ch, deadline):
        while True:
            try:
                v = ch.read(timeout=_DRIVER_BLOCK_SLICE_S)
                if isinstance(v, _CtrlMsg):
                    # stray recovery marker from a completed epoch (e.g. a
                    # done-wave the pump already accounted): not a value
                    continue
                if type(v) is _DagInput:
                    # a sampled step's trace envelope reached a driver
                    # output channel; the caller wants the bare value
                    v = v.value
                return v
            except TimeoutError:
                if self._torn:
                    raise self._err("torn down")
                self._check_loops()
                if deadline is not None and time.monotonic() >= deadline:
                    raise GetTimeoutError(
                        f"timed out waiting for compiled-DAG {self._dag_id} "
                        f"output")
            except ChannelClosed as e:
                if self._torn:
                    raise self._err("torn down") from e
                self._check_loops()
                src = self._ends.get(ch.path, (None, "driver"))[0]
                raise self._err(f"output channel closed: {e}",
                                node=self._labels.get(src, src)) from e

    # ------------------------------------------------------------- recovery

    def _check_loops(self):
        """A loop task resolving while executions are pending means its
        actor died (or the loop crashed). When the actor has restart budget
        the plane is RECOVERED in place: fresh channels for the dead
        actor's edges, a re-provisioned exec loop, and an in-band rewire of
        the surviving loops. Otherwise the DAG degrades to the submit-path
        fallback. Caller holds self._lock."""
        dead = self._dead_loops()
        if dead:
            self._recover(dead)

    def _dead_loops(self) -> dict:
        import ray_tpu_torch

        dead: dict[str, Exception] = {}
        for aid, ref in self._loops.items():
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0)
            if not ready:
                continue
            try:
                out = ray_tpu_torch.get(ref)
                exc: Exception = self._err(
                    f"execution loop exited prematurely: {out!r}",
                    node=self._labels.get(aid))
            except Exception as e:  # noqa: BLE001 — the death reason itself
                exc = e
            dead[aid] = exc
        return dead

    def _recover(self, dead: dict) -> None:
        """Drive recovery to completion (or degrade). Raises _PlaneRewired
        so blocked read/write loops restart on the fresh channel objects,
        or _PlaneDegraded after dismantling the plane."""
        from ray_tpu_torch._private.ray_config import RayConfig

        t0 = time.monotonic()
        deadline = t0 + float(
            getattr(RayConfig.instance(), "dag_recovery_timeout_s", 60.0))
        first_dead = sorted(dead)
        try:
            while dead:
                try:
                    self._recover_epoch(dead, deadline)
                    dead = self._dead_loops()  # another death during replay?
                except _MoreDead as m:
                    # an actor died while the barrier was in flight: fold
                    # the new failure into the next epoch (the cumulative
                    # remap keeps half-rewired loops convergent)
                    dead = m.dead
        except _PlaneDegraded:
            self._note_recovery("degraded", first_dead, t0)
            raise
        self.recoveries += 1
        self._note_recovery("recovered", first_dead, t0)
        raise _PlaneRewired()

    def _note_recovery(self, outcome: str, aids: list, t0: float) -> None:
        """Observability: `ray_tpu_dag_recoveries_total` counter + one
        timeline span per recovery (the task-events plumbing: the driver
        flusher ships it to the GCS, and the timeline renders it under the
        DAG's row)."""
        try:
            from ray_tpu_torch._private import task_events
            from ray_tpu_torch.util.metrics import Counter, get_or_create

            c = get_or_create(
                Counter, "ray_tpu_dag_recoveries_total",
                "compiled-DAG exec-loop recoveries (channel plane), by "
                "outcome: recovered = plane rewired in place, degraded = "
                "fell back to the submit path",
                tag_keys=("dag_id", "outcome"))
            # unlike the per-step series (retired at teardown), recovery
            # counts survive the DAG: they only exist for DAGs that hit an
            # incident, so cardinality is bounded by actual failures and
            # the evidence outlives the teardown that follows a degrade
            c.inc(tags={"dag_id": self._dag_id or "", "outcome": outcome})
            dur = time.monotonic() - t0
            end = time.time()
            task_events.emit(
                "dag:recovery",
                name="recover:" + "+".join(a[:8] for a in aids),
                start=end - dur, end=end,
                dag_id=self._dag_id, actors=[a[:8] for a in aids],
                epoch=self._epoch, outcome=outcome,
                duration_s=round(dur, 6))
        except Exception:  # noqa: BLE001 — observability must not break recovery
            pass

    def _recover_epoch(self, dead: dict, deadline: float) -> None:
        """One recovery generation: wait for the core restarts, re-channel
        the dead actors' edges, re-provision their loops, then pump the
        in-band barrier until every surviving loop has rewired, and finally
        replay (or error-settle) the in-flight window."""
        from ray_tpu_torch._private import serialization as ser

        self._epoch += 1
        epoch = self._epoch
        for aid in dead:
            self._wait_actor_restart(aid, dead, deadline)

        # fresh segments for every edge touching a dead actor; stale ones
        # are unlinked after the barrier completes. Flags per stale
        # segment, decided NOW (while `dead` describes this epoch):
        # needs_marker — a surviving reader may be parked on it, inject
        # the rewire marker there; needs_ack — its reader is dead, so a
        # surviving writer parked on the ack needs force_ack to move.
        remap: dict[str, MutableShmChannel] = {}
        flags: dict[str, tuple[bool, bool]] = {}
        try:
            for path, (src, dst) in list(self._ends.items()):
                if src in dead or dst in dead:
                    remap[path] = create_mutable_channel(self._buffer_bytes)
                    flags[path] = (
                        src in dead and dst not in dead and dst != "driver",
                        dst in dead)
        except BaseException:
            # a failed create mid-loop (ENOSPC on /dev/shm is the likely
            # one during an incident) must not strand the replacements
            # already created: they are not yet in _all_chans, so neither
            # teardown nor degrade would ever unlink them
            for ch in remap.values():
                ch.close()
                ch.unlink()
            raise
        replaced = self._apply_remap(remap)
        self._stale.extend((ch, *flags[ch.path]) for ch in replaced)

        # re-provision each dead actor's exec loop over the remapped plan;
        # the resync epoch makes the new loop run the barrier before its
        # first step (its fresh in-edges synchronize with the survivors)
        for aid in dead:
            plan = self._plans[aid]
            plan["resync"] = epoch
            try:
                self._loops[aid] = self._worker.submit_actor_task(
                    aid, EXEC_LOOP_METHOD, (plan,), {}, num_returns=1,
                    max_task_retries=0)[0]
            except Exception as e:  # noqa: BLE001 — submit failure → degrade
                self._degrade(dead, f"exec-loop re-provision failed: {e!r}")

        self._pump_barrier(dead, epoch, deadline)
        # barrier done: every loop resynced, so no loop touches ANY stale
        # segment (this epoch's or an aborted predecessor's) anymore
        for ch, _marker, _ack in self._stale:
            try:
                self._all_chans.remove(ch)
            except ValueError:
                pass
            ch.close()
            ch.unlink()
        self._stale.clear()
        # the same invariant retires the remap history: every loop is on
        # the current wiring, so future markers only need remaps newer
        # than this barrier — without this, rc_blob (and every resyncing
        # loop's channel attach set) grows per recovery forever
        self._cum_remap.clear()
        self._replay_or_settle(dead, deadline, ser)

    def _wait_actor_restart(self, aid: str, dead: dict,
                            deadline: float) -> None:
        """Block (poll-style, teardown-abortable) until the GCS restarted
        the actor; degrade when it can't ('actor_death' fallback instead of
        a bricked DAG)."""
        label = self._labels.get(aid, aid[:8])
        while True:
            if self._torn:
                raise self._err("torn down during recovery")
            try:
                info = self._worker.rpc({"type": "actor_info", "aid": aid})
            except Exception as e:  # noqa: BLE001 — GCS unreachable
                self._degrade(dead, f"actor state unavailable ({e!r})")
            if not info.get("found") or info.get("state") == "dead":
                self._degrade(
                    dead, f"actor {aid[:8]} ({label}) died with no restart "
                          f"budget left")
            if info.get("state") == "alive":
                if info.get("host") not in (None, self._worker.host_id):
                    # restarted onto another host: shm channels can't span
                    # hosts — the submit path can
                    self._degrade(
                        dead, f"actor {aid[:8]} restarted on host "
                              f"{info.get('host')} (driver on "
                              f"{self._worker.host_id})")
                return
            if time.monotonic() >= deadline:
                self._degrade(
                    dead, f"actor {aid[:8]} ({label}) restart timed out")
            time.sleep(0.05)

    def _apply_remap(self, remap: dict) -> list:
        """Swap every driver-side reference from the stale channels to the
        fresh ones; returns the replaced (old) channel objects."""
        if not remap:
            return []
        replaced = []
        for plan in self._plans.values():
            st = _LoopState(plan["ops"], plan.get("input"))
            st.apply(remap)
            plan["input"] = st.input
        self._in_chans = [remap.get(c.path, c) for c in self._in_chans]
        self._out_chans = [remap.get(c.path, c) for c in self._out_chans]
        for path, new in remap.items():
            self._ends[new.path] = self._ends.pop(path)
            self._all_chans.append(new)
        for ch in self._all_chans:
            if ch.path in remap:
                replaced.append(ch)
        # collapse the history so older epochs' stale paths point at the
        # CURRENT segment (late loops apply one hop, not a chain)
        for old_path, tgt in list(self._cum_remap.items()):
            if tgt.path in remap:
                self._cum_remap[old_path] = remap[tgt.path]
        self._cum_remap.update(remap)
        return replaced

    def _pump_barrier(self, dead: dict, epoch: int,
                      deadline: float) -> None:
        """Single-threaded driver pump, all non-blocking slices:
        - inject sync+done markers into every channel the DRIVER may write
          (its input channels, post-remap) — the flood covers the rest;
        - inject sync markers into stale out-edges of dead writers, where
          a survivor may be blocked reading a channel no one will feed —
          including edges stranded by a _MoreDead-aborted earlier epoch;
        - force-ack stale channels whose reader died, so survivors blocked
          on a dead reader's ack finish their write and reach the marker;
        - drain every driver out-channel up to its done marker (discarding
          the aborted window's partials);
        - watch for teardown, timeout, and further loop deaths."""
        from ray_tpu_torch._private import serialization as ser

        rc_blob = ser.dumps(_Reconfigure(epoch, dict(self._cum_remap)))
        done_blob = ser.dumps(_ReconfigureDone(epoch))
        # MUST-flush injections: the driver's input channels carry the
        # sync+done waves into the first-stage loops, which consume them
        # during their resync drains — these always land eventually.
        # (channel, [payloads still to write, in order])
        must: list[tuple[MutableShmChannel, list]] = [
            (ch, [rc_blob, done_blob]) for ch in self._in_chans]
        # OPPORTUNISTIC injections: a survivor may be parked reading an
        # abandoned stale edge whose writer died — one sync marker (with
        # the remap) frees it. But if that survivor resynced via ANOTHER
        # in-edge first, nobody ever drains this channel again and the
        # write may never land; the done wave on the output channels
        # already proves every loop resynced, so completion must not wait
        # on these. No done wave here: the edge is abandoned post-remap.
        opportunistic: list[tuple[MutableShmChannel, list]] = [
            (ch, [rc_blob]) for ch, needs_marker, _a in self._stale
            if needs_marker]
        ack = [ch for ch, _m, needs_ack in self._stale if needs_ack]
        out_state = {ch.path: "sync" for ch in self._out_chans}
        self._row = []  # partial pre-crash row: replay regenerates it
        while True:
            if self._torn:
                raise self._err("torn down during recovery")
            if time.monotonic() >= deadline:
                self._degrade(dead, "recovery barrier timed out")
            more = {a: e for a, e in self._dead_loops().items()}
            if more:
                raise _MoreDead(more)
            progressed = False
            for ch, todo in (*must, *opportunistic):
                if todo:
                    try:
                        ch.write_serialized(todo[0], timeout=0)
                        todo.pop(0)
                        progressed = True
                    except (TimeoutError, ValueError):
                        pass
                    except ChannelClosed:
                        todo.clear()
            for ch in ack:
                ch.force_ack()
            for ch in self._out_chans:
                st = out_state[ch.path]
                if st == "done":
                    continue
                try:
                    v = ch.read(timeout=0)
                except (TimeoutError, ChannelClosed):
                    continue
                progressed = True
                if isinstance(v, _Reconfigure) and v.epoch >= epoch:
                    out_state[ch.path] = "sync_seen"
                elif isinstance(v, _ReconfigureDone) and v.epoch >= epoch:
                    out_state[ch.path] = "done"
                # anything else: stale partial-row payload — discarded
            if (all(st == "done" for st in out_state.values())
                    and all(not todo for _ch, todo in must)):
                return
            if not progressed:
                time.sleep(0.001)

    def _replay_or_settle(self, dead: dict, deadline: float, ser) -> None:
        """The in-flight window [drained, submitted): with enable_retry the
        retained input rows are re-fed in order (results stay exactly-once
        at the driver — the barrier flushed every partial payload); without
        it each step settles as an in-band error naming the dead node."""
        pending = range(self._drained, self._submitted)
        if not self._enable_retry:
            labels = ", ".join(
                self._labels.get(a, a[:8]) for a in sorted(dead))
            for seq in pending:
                # settled driver-locally (never rides a channel): keep the
                # BARE ActorDiedError so result() raises the same type the
                # submit plane surfaces for a dead actor
                err = _PipelineError(labels, ActorDiedError(
                    f"compiled DAG {self._dag_id}: execution #{seq} was "
                    f"in flight when node(s) {labels} died "
                    f"(enable_retry=False; compile with "
                    f"enable_retry=True to replay)"))
                self._results[seq] = [err] * len(self._out_chans)
                self._inputs.pop(seq, None)
            self._drained = self._submitted
            self._row = []
            return
        labels = ", ".join(self._labels.get(a, a[:8]) for a in sorted(dead))
        for seq in pending:
            payload = self._inputs.get(seq)
            if payload is None:
                # defensive (every admitted seq retains its row while
                # enable_retry is on): replay a POISON input so the
                # pipeline still produces a row for this seq — skipping it
                # would shift every later seq onto the wrong result row
                payload = ser.dumps(_PipelineError(labels, ActorDiedError(
                    f"compiled DAG {self._dag_id}: execution #{seq} lost "
                    f"its retained input row across the recovery from "
                    f"node(s) {labels}")))
            for ch in self._in_chans:
                while True:
                    if self._torn:
                        raise self._err("torn down during recovery")
                    if time.monotonic() >= deadline:
                        self._degrade(dead, "in-flight replay timed out")
                    more = self._dead_loops()
                    if more:
                        raise _MoreDead(more)
                    try:
                        ch.write_serialized(payload, timeout=0.01)
                        break
                    except TimeoutError:
                        while self._drain_one_nonblocking():
                            pass

    def _degrade(self, dead: dict, detail: str):
        """Dismantle the channel plane after an unrecoverable death: close
        and unlink everything, settle the in-flight window as errors naming
        the dead node, release the actors, and hand the DAG to the
        submit-path fallback. Never returns (raises _PlaneDegraded)."""
        import ray_tpu_torch

        labels = ", ".join(self._labels.get(a, a[:8]) for a in sorted(dead))
        logger.warning(
            "compiled DAG %s: degrading to the submit-path fallback after "
            "death of %s (%s)", self._dag_id, labels, detail)
        self._degraded = f"actor_death: {labels} ({detail})"
        for ch in self._all_chans:
            ch.close()
        for seq in range(self._drained, self._submitted):
            err = _PipelineError(labels, ActorDiedError(
                f"compiled DAG {self._dag_id}: execution #{seq} was in "
                f"flight when node(s) {labels} died and the channel plane "
                f"degraded to the submit path ({detail})"))
            self._results[seq] = [err] * len(self._out_chans)
        self._drained = self._submitted
        self._row = []
        self._inputs.clear()
        # the loops exit via ChannelClosed; join briefly so the actors'
        # concurrency slots free before the submit plane targets them
        t_join = time.monotonic() + 5.0
        for aid, ref in self._loops.items():
            if aid in dead:
                continue  # already resolved (that's how we got here)
            try:
                ray_tpu_torch.get(
                    ref, timeout=max(0.1, t_join - time.monotonic()))
            except Exception:  # noqa: BLE001 — best-effort; teardown re-joins
                pass
        for ch in self._all_chans:
            ch.unlink()
        _release_actors(self._order)
        raise _PlaneDegraded(self._degraded)

    # -------------------------------------------------------------- teardown

    def teardown(self, raise_on_error: bool = False) -> list:
        """Close every channel (unblocking all loops wherever they are),
        join the loops, and unlink every /dev/shm file. Idempotent."""
        import ray_tpu_torch

        with self._torn_lock:  # NOT self._lock: a result()/execute()
            # blocked on a channel holds that and exits via _torn
            if self._torn:
                return []
            self._torn = True
        for ch in self._all_chans:
            ch.close()
        errors: list[tuple[str, Exception]] = []
        still_running: set[str] = set()
        for aid, ref in self._loops.items():
            try:
                ray_tpu_torch.get(ref, timeout=self._join_timeout(aid, ref))
            except GetTimeoutError as e:
                # the loop is wedged in a user op: keep the actor claimed,
                # or a recompile over it would queue behind the stuck loop
                # and hang silently — the very failure the occupancy
                # registry exists to surface
                still_running.add(aid)
                errors.append((aid, e))
            except Exception as e:  # noqa: BLE001 — collected, logged below
                errors.append((aid, e))
        _release_actors([a for a in self._order if a not in still_running])
        for ch in self._all_chans:
            ch.unlink()
        if self._h_bp_src is not None:
            # retire this DAG's driver-side series (see _LoopInstr.retire)
            self._h_bp_src[0].remove(self._h_bp_src[1])
        if errors:
            logger.warning(
                "compiled DAG teardown: %d execution-loop error(s); first "
                "(actor %s): %r", len(errors), errors[0][0][:8],
                errors[0][1])
            if raise_on_error:
                raise errors[0][1]
        return errors

    def _join_timeout(self, aid: str, ref) -> float:
        """Dead-loop fast path: a loop whose ref is unresolved AND whose
        actor is no longer alive will never return on its own — joining it
        with the full budget would burn 30s PER dead actor in teardown.
        The short grace only covers the GCS death-propagation window."""
        import ray_tpu_torch

        try:
            if ray_tpu_torch.wait([ref], num_returns=1, timeout=0)[0]:
                return 30.0  # resolved: the get() below returns immediately
            info = self._worker.rpc({"type": "actor_info", "aid": aid})
            if info.get("found") and info.get("state") == "alive":
                return 30.0
        except Exception:  # noqa: BLE001 — fall through to the full join
            return 30.0
        return 2.0

    def __del__(self):
        # executor dropped without teardown: still release the actors and
        # the /dev/shm bytes. No loop joins here — blocking get()s have no
        # place in GC; the closed flag alone makes the loops exit.
        try:
            with self._torn_lock:
                if self._torn:
                    return
                self._torn = True
            _release_actors(self._order)
            for ch in self._all_chans:
                ch.close()
                ch.unlink()
        except Exception:
            pass


# --------------------------------------------------------------------------
# compile-time planner
# --------------------------------------------------------------------------


def try_build(root, schedule, *, max_inflight: int,
              buffer_bytes: int = 1 << 20, dag_id: str | None = None,
              enable_retry: bool = False):
    """Partition `schedule` into per-actor exec-loop plans and provision
    the channel plane. Returns (executor, None) on success or
    (None, fallback_reason) when the graph/topology can't ride SPSC
    same-host channels."""
    from ray_tpu_torch._private.api import _get_worker
    from ray_tpu_torch._private.ray_config import RayConfig
    from ray_tpu_torch.dag.dag_node import (ClassMethodNode, DAGNode,
                                            InputNode, MultiOutputNode)

    if os.environ.get("RAY_TPU_TORCH_DAG_CHANNELS", "1") == "0":
        return None, "disabled via RAY_TPU_TORCH_DAG_CHANNELS=0"
    worker = _get_worker()
    if getattr(worker, "kind", None) != "driver" or not hasattr(worker, "rpc"):
        return None, "channel plane requires a cluster-mode driver"

    multi = isinstance(root, MultiOutputNode)
    outputs = list(root._upstream()) if multi else [root]
    actor_nodes: list = []
    n_inputs = 0
    for node in schedule:
        if node is root and multi:
            continue
        if isinstance(node, InputNode):
            n_inputs += 1
            continue
        if isinstance(node, MultiOutputNode):
            return None, "interior MultiOutputNode requires the submit path"
        if not isinstance(node, ClassMethodNode):
            return None, (f"{type(node).__name__} requires the submit path "
                          "(only actor-method nodes ride channels)")
        if node._method._num_returns != 1:
            return None, "num_returns != 1 requires the submit path"
        actor_nodes.append(node)
    if n_inputs > 1:
        return None, "multiple InputNodes require the submit path"
    if not actor_nodes:
        return None, "no actor-method nodes in the graph"
    for out in outputs:
        if not isinstance(out, ClassMethodNode):
            return None, "non-actor output requires the submit path"

    # same-host gate: SPSC mutable-shm channels need every loop AND the
    # driver on one host; cross-host graphs keep the submit path
    aids: list[str] = []
    for node in actor_nodes:
        aid = node._method._actor_id
        if aid not in aids:
            aids.append(aid)
    try:
        for aid in aids:
            worker.wait_actor_ready(aid, timeout=60.0)
        rows = worker.rpc({"type": "list_workers"}).get("workers", [])
    except Exception as e:  # noqa: BLE001 — compile must not crash; fallback
        return None, f"actor placement unavailable ({e!r})"
    host_of = {r["actor_id"]: r["host"] for r in rows if r.get("actor_id")}
    for aid in aids:
        host = host_of.get(aid)
        if host is None:
            return None, f"actor {aid[:8]} placement unknown"
        if host != worker.host_id:
            return None, (f"actor {aid[:8]} is on host {host} (driver on "
                          f"{worker.host_id}): cross-host edges need the "
                          "submit path")

    # a second compiled DAG over a busy actor would hang, not degrade —
    # raising beats both silent queuing and the submit-path fallback
    # (whose .remote() calls would queue behind the loop just the same)
    _claim_actors(aids)

    # ---- partition into per-actor op lists + allocate per-edge channels
    all_chans: list[MutableShmChannel] = []
    topology: list[dict] = []  # channel edges for the DAG registry
    # shm path → (writer, reader), each "driver" or an actor id: recovery
    # must know every channel adjacent to a dead actor, which old endpoint
    # to force-ack, and where to inject rewire markers
    ends: dict[str, tuple[str, str]] = {}

    def new_chan():
        ch = create_mutable_channel(buffer_bytes)
        all_chans.append(ch)
        return ch

    # instrumentation knobs, stamped into every plan at compile time so
    # the exec loops inherit the DRIVER's config (no worker env plumbing)
    cfg = RayConfig.instance()
    metrics_on = bool(getattr(cfg, "dag_metrics", True))
    sample = max(0, int(getattr(cfg, "dag_span_sample_every", 0)))

    try:
        plans: dict[str, dict] = {
            aid: {"ops": [], "input": None, "needs_input": False,
                  "dag_id": dag_id, "metrics": metrics_on, "sample": sample}
            for aid in aids}
        node_loc: dict[int, tuple[str, int]] = {}  # id(node) → (aid, reg)
        for node in actor_nodes:
            aid = node._method._actor_id
            plan = plans[aid]
            label = f"{node._method._method_name}@actor:{aid[:8]}"

            def enc(a, aid=aid, plan=plan, label=label):
                if isinstance(a, InputNode):
                    plan["needs_input"] = True
                    return ("input",)
                if isinstance(a, DAGNode):
                    p_aid, p_reg = node_loc[id(a)]
                    if p_aid == aid:
                        return ("reg", p_reg)
                    # one channel PER CONSUMING ARG: depth-1 SPSC buffers
                    # can't be read twice per step
                    ch = new_chan()
                    plans[p_aid]["ops"][p_reg]["out"].append(ch)
                    ends[ch.path] = (p_aid, aid)
                    topology.append(
                        {"from": plans[p_aid]["ops"][p_reg]["label"],
                         "to": label})
                    return ("chan", ch)
                return ("const", a)

            op = {"method": node._method._method_name,
                  "args": [enc(a) for a in node._bound_args],
                  "kwargs": {k: enc(v)
                             for k, v in node._bound_kwargs.items()},
                  "out": [],
                  "label": label}
            plan["ops"].append(op)
            node_loc[id(node)] = (aid, len(plan["ops"]) - 1)

        # driver input channels: actors that consume the InputNode, plus a
        # pacing tick for any actor with an un-paced op (no transitive
        # channel/input dependency) — without it a source op would free-run
        # ahead of execute() calls, advancing actor state speculatively
        in_chans: list[MutableShmChannel] = []
        for aid in aids:
            plan = plans[aid]
            paced: list[bool] = []
            for op in plan["ops"]:
                encs = list(op["args"]) + list(op["kwargs"].values())
                paced.append(any(
                    e[0] in ("chan", "input")
                    or (e[0] == "reg" and paced[e[1]]) for e in encs))
            if plan.pop("needs_input") or not all(paced):
                ch = new_chan()
                plan["input"] = ch
                in_chans.append(ch)
                ends[ch.path] = ("driver", aid)
                topology.append({"from": "driver",
                                 "to": f"loop@actor:{aid[:8]}"})

        # driver output channels, one per output occurrence (root order)
        out_chans: list[MutableShmChannel] = []
        for out_node in outputs:
            aid, reg = node_loc[id(out_node)]
            ch = new_chan()
            plans[aid]["ops"][reg]["out"].append(ch)
            out_chans.append(ch)
            ends[ch.path] = (aid, "driver")
            topology.append({"from": plans[aid]["ops"][reg]["label"],
                             "to": "driver"})

        executor = ChannelExecutor(
            worker, plans, aids, in_chans, out_chans, all_chans,
            max_inflight=max_inflight, multi=multi, dag_id=dag_id,
            sample=sample, metrics_on=metrics_on, topology=topology,
            ends=ends, buffer_bytes=buffer_bytes,
            enable_retry=enable_retry)
        executor._provision()
        return executor, None
    except Exception as e:  # noqa: BLE001 — release shm, then fall back
        _release_actors(aids)
        for ch in all_chans:
            ch.close()
            ch.unlink()
        logger.warning("channel-plane compile failed; falling back to the "
                       "submit path: %r", e)
        return None, f"channel plane provisioning failed ({e!r})"
