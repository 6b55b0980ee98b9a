"""LLMEngine: continuous-batching inference on one GPU.

The counterpart of ray_tpu/llm/engine.py ``TPUEngine``. The scheduler
thread owns the device state and runs the continuous-batching loop (admit →
prefill into a free slot → one decode step for every live row →
emit/eject):

- prompt lengths are padded to power-of-two buckets (>= page_size on the
  paged layout; on the card >= the flash kernel's tile, so its tiles divide
  every prefill),
- ``kv_layout="slot"`` (the default, as in the JAX package) keeps one
  contiguous [slots, max_len] cache row per sequence; ``"paged"`` keeps KV
  in a shared page pool, grants each admission every page the sequence will
  ever touch, and backlogs a request that does not fit until pages free up,
- on the paged layout each decode step sweeps only ``_pages_bound()``
  block-table columns: the power-of-two bound on the batch's live page span,
- sampling is per row on the device; only the sampled ids cross to the host.

The options of the JAX engine, each held token-exact to it under greedy
decoding:

- ``enable_prefix_cache`` (paged): chain-hashed full prompt blocks map to
  pages still resident in the pool; a hit wires them into the new row's
  block table and only the suffix runs (``prefill_with_prefix``),
- ``prefill_chunk`` (paged): a prompt longer than one chunk prefills one
  chunk per scheduler pass, between decode steps,
- ``speculative_k`` (slot): n-gram drafts from the request's own history,
  verified K at a time (``decoding.verify_step``),
- ``max_loras`` / ``load_lora`` (slot): per-row LoRA adapters in the same
  batched step,
- ``SamplingParams.guided``: a token FSM (llm/guided.py) biases each
  guided row's logits,
- ``attn_impl="gather"`` (paged): the full-table gather decode step instead
  of the ragged kernel.

Where the scheduler's time goes: ``stats()`` splits the decode step into
its launch and its sync (with the launch's thread CPU time), Serve's
engine phase histogram times each request's queue wait and prefill, and
``start_profile``/``stop_profile`` bracket a device trace whose idle time
is put down to the scheduler phase that was open.

On the card, whole-prompt prefills and first chunks run the flash kernel
and the paged ragged decode step the ragged paged kernel (as in
ray_tpu/llm/engine.py:306-307, iff the device can run it); the slot and
verify steps, the gather step and the continuation prefill are plain
PyTorch, as their JAX counterparts use no Pallas kernel.

PD disaggregation: ``submit_prefilled`` admits a sequence whose prefill
ran elsewhere, as whole K/V arrays, as transferred pages, or as a
``kv_transfer.KVPageStream`` still being fed (the slot and its pages are
granted at once, each page is adopted as it arrives, between decode
steps, and the row activates on the last page). Pages arrive as host
tensors and go to the pool's device with one copy a page.

Tensor parallelism, ``mesh=`` (a DeviceMesh with a "tp" dimension, every
other dimension of size 1): every rank of the mesh builds the same engine
from the same full params and runs the same scheduler on the same
requests (submitted in the same order on every rank). A rank keeps the
counterpart of the JAX engine's ``_shard_params_tp`` cut: its contiguous
slice of the attention heads (tp | n_kv_heads, so each GQA group stays on
one rank) and of the dense mlp hidden dim, everything else replicated; its
KV cache or page pool is its own contiguous tensor of n_kv_heads / tp
heads, so the ragged kernel runs on the rank's pool (the JAX engine turns
its Pallas kernel off under a mesh only because a GSPMD array is not a
local one). The blocks allreduce their partial outputs over tp. Every
scheduler pass starts with one small allreduce that makes the ranks agree
on how many requests and aborts they have all received, on shutdown and on
the clock the deadlines are read against; sampled tokens are broadcast
from tp rank 0. A rank whose scheduler dies leaves the others waiting in
a collective until the process group's timeout.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import logging
import queue
import sys
import threading
import time

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.exceptions import DeadlineExceededError, RequestCancelledError
from ray_tpu_torch.llm import guided as _guided
from ray_tpu_torch.models import decoding
from ray_tpu_torch.models import decoding_paged as dp
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.ops import flash_attention
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import (MESH_AXIS_TP, axis_rank,
                                         mesh_shape, use_mesh)
from ray_tpu_torch.util import device_trace, tracing

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    stop_token_ids: tuple = ()
    # constrained decoding: a llm.guided.GuidedFSM over token ids
    guided: object | None = None


@dataclasses.dataclass
class _Request:
    rid: int
    tokens: list
    params: SamplingParams
    out_queue: queue.SimpleQueue = dataclasses.field(default_factory=queue.SimpleQueue)
    slot: int = -1
    generated: int = 0
    # the row's device length at activation, mirrored host-side so the
    # ragged decode step can bound its page sweep without a readback
    length0: int = 0
    # chunked-prefill progress (_prefill_step)
    pf_done: int = 0
    pf_pages: list | None = None
    pf_hashes: list | None = None
    # full token history (prompt + emitted) for the n-gram draft proposer,
    # and its index: trailing n-gram → (latest, previous) continuation starts
    history: list = dataclasses.field(default_factory=list)
    ngram_index: dict | None = None
    accepted: int = 0  # drafts of this request that verification accepted
    # multi-LoRA: bank index this request decodes with (0 = base model)
    lora_idx: int = 0
    lora_released: bool = False
    # absolute wall-clock deadline (0 = none)
    deadline_ts: float = 0.0
    # prefilled elsewhere (PD): the transferred KV and first token, and for
    # streamed admission the kv_transfer.KVPageStream still being fed
    kv_pack: dict | None = None
    kv_stream: object | None = None
    # request-phase stamps (wall clock): submit → the pass that starts its
    # admission is the queue wait, from there to the first token the
    # prefill, submit → slot bind the admission wait; _emit times the
    # inter-token gap off last_emit_ts; llm/pd.py's decode_stream reads
    # them for retroactive spans
    submitted_ts: float = 0.0
    started_ts: float = 0.0
    admitted_ts: float = 0.0
    last_emit_ts: float = 0.0
    # the submitter's span context (util/tracing.py), None when unsampled
    trace_ctx: dict | None = None

    def __iter__(self):
        """Yield generated tokens as they are produced."""
        return _iter_request(self)


_SENTINEL = object()


def _rebuilt_error(msg: str) -> BaseException:
    """The exception tp rank 0 met on a stream, rebuilt on another rank
    from its class path and message (one line each): the same class,
    looked up among the loaded modules, built from the message, or a
    RuntimeError naming the class when it cannot be."""
    path, _, text = msg.partition("\n")
    mod, _, name = path.rpartition(".")
    cls = getattr(sys.modules.get(mod), name, None)
    if isinstance(cls, type) and issubclass(cls, BaseException):
        try:
            return cls(text)
        except Exception:  # noqa: BLE001 — a class not built from a message
            pass
    return RuntimeError(f"{name}: {text}")


class _EngineError:
    """End-of-stream marker carrying the scheduler's failure."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _RequestError(_EngineError):
    """End-of-stream marker for a per-request failure (cancel, deadline)."""


def _iter_request(req: _Request):
    while True:
        tok = req.out_queue.get()
        if tok is _SENTINEL:
            return
        if isinstance(tok, _RequestError):
            raise tok.exc
        if isinstance(tok, _EngineError):
            raise RuntimeError("engine scheduler died mid-generation") from tok.exc
        yield tok


def bucket_for(n: int, min_bucket: int, max_len: int) -> int:
    """Smallest power-of-two bucket >= n (starting at min_bucket, capped at
    max_len)."""
    b = min_bucket
    while b < n and b < max_len:
        b *= 2
    return min(b, max_len)


def _check_tp_mesh(mesh, cfg: TransformerConfig) -> int:
    """The tp degree of an engine mesh, after checking the mesh."""
    import torch.distributed as dist

    if not hasattr(mesh, "mesh_dim_names") or not hasattr(mesh, "get_group"):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh with a "
                        f"'tp' dimension, got {mesh!r}")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("the mesh's process group is not initialised "
                           "(start the ranks with parallel.launch)")
    shape = mesh_shape(mesh)
    if MESH_AXIS_TP not in shape or any(
            n != 1 for a, n in shape.items() if a != MESH_AXIS_TP):
        raise ValueError(f"the engine shards over one 'tp' dimension (every "
                         f"other of size 1); got {shape}")
    tp = shape[MESH_AXIS_TP]
    if cfg.kv_heads % tp or cfg.n_heads % tp or cfg.d_ff % tp:
        raise ValueError(
            f"tp={tp} must divide n_kv_heads {cfg.kv_heads} (each GQA group "
            f"stays on one rank), n_heads {cfg.n_heads} and d_ff {cfg.d_ff}")
    return tp


def _tp_split_dim(path: tuple) -> int | None:
    """The dim the engine's tensor-parallel cut splits a leaf on (the JAX
    engine's ``_shard_params_tp`` rule), or None (replicated)."""
    if path[0] != "layers":
        return None
    group, name = path[1], path[-1]
    if group == "attn":
        return {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "bq": 1, "bk": 1,
                "bv": 1}.get(name)
    if group == "mlp":  # the dense mlp's hidden dim; MoE experts replicate
        return {"wi": 2, "wi_gate": 2, "wi_up": 2, "wo": 1,
                "bi": 1}.get(name)
    return None


def shard_params_tp(params: dict, mesh) -> dict:
    """This rank's tensor-parallel cut of the full param tree: contiguous
    slices of the heads and dense mlp hidden dim, the rest shared with the
    full tree (no copy)."""
    tp = mesh_shape(mesh)[MESH_AXIS_TP]
    r = axis_rank(mesh, MESH_AXIS_TP)

    def cut(tree, path):
        if isinstance(tree, dict):
            return {k: cut(v, path + (k,)) for k, v in tree.items()}
        d = _tp_split_dim(path)
        if d is None:
            return tree
        n = tree.shape[d] // tp
        return tree.narrow(d, r * n, n).contiguous()

    return cut(params, ())


# spans one device trace keeps (LLMEngine.start_profile); later ones are
# counted as dropped
PROFILE_SPANS_MAX = 1 << 17
# the longest slice: the scheduler stops a profile left on this long itself.
# The stop and the reduction stall the scheduler 75-100 us for each kernel
# recorded (Mixtral chat on an H100: ~38k kernels a second, so a 10 s slice
# stalls it 30-40 s); the cap keeps that stall, and the profiler's memory,
# inside the proxy's 60 s request time limit
PROFILE_SLICE_MAX_S = 10.0
# a profiler's start or stop on the scheduler's thread: CUPTI's first start
# in a process and the stop's processing of every recorded kernel take
# seconds on the card
PROFILE_CALL_TIMEOUT_S = 300.0


def _pow2_at_least(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class LLMEngine:
    """Continuous-batching engine on one GPU (or the CPU when asked for);
    the counterpart of ``ray_tpu.llm.engine.TPUEngine``."""

    def __init__(self, cfg: TransformerConfig, params: dict, *,
                 max_slots: int = 8, max_len: int | None = None,
                 min_bucket: int = 32, seed: int = 0,
                 kv_layout: str = "slot", page_size: int = 64,
                 num_pages: int | None = None,
                 max_prefills_per_step: int = 2,
                 enable_prefix_cache: bool = False,
                 prefill_chunk: int | None = None,
                 speculative_k: int = 0, ngram_size: int = 2,
                 mesh=None, max_loras: int = 0, lora_rank: int = 8,
                 attn_impl: str = "auto", device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        # the state's (and LoRA bank's) head counts: this rank's
        state_cfg = cfg
        if mesh is not None:
            tp = _check_tp_mesh(mesh, cfg)
            params = shard_params_tp(params, mesh)
            state_cfg = dataclasses.replace(
                cfg, n_heads=cfg.n_heads // tp,
                n_kv_heads=cfg.kv_heads // tp, d_head=cfg.head_dim)
        self.params = params
        self.max_len = max_len or cfg.max_seq_len
        if self.max_len > cfg.max_seq_len:
            raise ValueError(
                f"engine max_len {self.max_len} exceeds the model's "
                f"max_seq_len {cfg.max_seq_len} (rope tables are sized by "
                "the model config)")
        if kv_layout not in ("slot", "paged"):
            raise ValueError(
                f"kv_layout must be 'slot' or 'paged', got {kv_layout!r}")
        self.kv_layout = kv_layout
        paged = kv_layout == "paged"
        if paged:
            if page_size <= 0 or (page_size & (page_size - 1)):
                raise ValueError("page_size must be a positive power of two")
            if self.max_len % page_size:
                raise ValueError(
                    f"max_len {self.max_len} must be a multiple of page_size "
                    f"{page_size} (buckets reshape into whole pages)")
            min_bucket = max(min_bucket, page_size)
        if self.device.type == "cuda":
            # every prefill bucket must tile into the flash kernel's rows
            tile = flash_attention.TILE
            min_bucket = max(min_bucket, tile)
            if self.max_len % tile:
                raise ValueError(f"max_len {self.max_len} must be a multiple "
                                 f"of the flash kernel's tile {tile} on CUDA")
        if paged and min_bucket % page_size:
            raise ValueError(
                f"min_bucket {min_bucket} must be a multiple of page_size "
                f"{page_size} (every prompt bucket reshapes into whole pages)")
        self.max_slots = max_slots
        self.buckets = []
        b = min_bucket
        while b < self.max_len:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(self.max_len)
        self.enable_prefix_cache = False
        self.prefill_chunk = None
        self._prefilling: list = []  # requests mid-chunked-prefill
        if paged:
            if prefill_chunk is not None and (
                    prefill_chunk not in self.buckets
                    or prefill_chunk % page_size):
                raise ValueError(
                    f"prefill_chunk {prefill_chunk} must be one of the "
                    f"engine's bucket sizes {self.buckets} and a multiple of "
                    f"page_size {page_size} — a non-bucket chunk would pad "
                    "past its own page span and corrupt neighboring pages")
            if attn_impl == "auto":
                attn_impl = "ragged"
            if attn_impl not in ("ragged", "gather"):
                raise ValueError(
                    f"attn_impl must be 'auto', 'ragged' or 'gather', "
                    f"got {attn_impl!r}")
            self.page_size = page_size
            self.max_pages_per_seq = -(-self.max_len // page_size)
            # default pool = full reservation (+1 scratch); pass num_pages
            # lower to oversubscribe device memory against short sequences
            self.num_pages = num_pages or (max_slots * self.max_pages_per_seq
                                           + 1)
            self.state = dp.init_paged_state(state_cfg, max_slots,
                                             self.max_len, self.num_pages,
                                             page_size, self.device)
            self._free_pages = list(range(1, self.num_pages))  # 0 = scratch
            self._slot_pages: dict[int, list] = {}
            # hash-block prefix cache over the same page pool
            self.enable_prefix_cache = bool(enable_prefix_cache)
            self._prefix_cache: collections.OrderedDict = \
                collections.OrderedDict()         # block-chain hash → page id
            self._page_refs: dict[int, int] = {}  # shared page → live users
            self._page_hash: dict[int, bytes] = {}  # reverse map (eviction)
            self._slot_shared: dict[int, list] = {}  # slot → shared pages
            self.prefix_hits = 0       # requests that reused >= 1 block
            self.prefix_misses = 0
            self.prefix_tokens_reused = 0
            self.prefill_chunk = prefill_chunk
            self.prefill_chunks_run = 0
        else:
            if enable_prefix_cache:
                raise ValueError(
                    "enable_prefix_cache requires kv_layout='paged'")
            if prefill_chunk is not None:
                raise ValueError("prefill_chunk requires kv_layout='paged'")
            attn_impl = "gather"
            self.state = decoding.init_decode_state(state_cfg, max_slots,
                                                    self.max_len, self.device)
        self.attn_impl = attn_impl
        self._ragged_kernel = (attn_impl == "ragged"
                               and self.device.type == "cuda")
        # speculative decoding: n-gram drafts verified in one step
        self.speculative_k = int(speculative_k)
        self.ngram_size = max(1, int(ngram_size))
        if self.speculative_k:
            if paged:
                raise ValueError(
                    "speculative_k requires kv_layout='slot' (the paged "
                    "verify step is not implemented)")
            if self.speculative_k < 1 or self.speculative_k > 16:
                raise ValueError("speculative_k must be in [1, 16]")
        # multi-LoRA: a device bank gathered per row in the batched step
        self.max_loras = int(max_loras)
        self.lora_rank = int(lora_rank)
        self.lora_bank = None
        if self.max_loras:
            if paged:
                raise ValueError(
                    "max_loras requires kv_layout='slot' (the paged decode "
                    "kernel has no LoRA gather yet)")
            if self.speculative_k:
                raise ValueError(
                    "max_loras and speculative_k cannot be combined (the "
                    "verify step has no LoRA gather)")
            self.lora_bank = decoding.init_lora_bank(
                state_cfg, self.max_loras, self.lora_rank, self.device)
            self._lora_free = list(range(1, self.max_loras + 1))
            self._lora_ids: dict[str, int] = {}   # name → bank index
            self._lora_refs: dict[int, int] = {}  # index → live requests
            self._slot_lora = torch.zeros((max_slots,), dtype=torch.int64,
                                          device=self.device)
            # load/unload run on callers' threads: they swap in a new bank
            # dict under this lock, so a step in flight sees the old one whole
            self._lora_lock = threading.Lock()
        self.decode_steps = 0
        self.decode_slot_steps = 0  # sum of active slots over decode steps
        self.spec_steps = 0
        self.spec_slot_steps = 0   # sum of active slots over verify steps
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.prefills = 0           # decoding.prefill calls (the flash path)
        self.prefix_prefills = 0    # prefill_with_prefix calls
        self.prefill_seconds = 0.0  # prefill + first-token sync, host clock
        self.decode_seconds = 0.0   # decode or verify step + sampling sync
        # its two parts: the launch (forward, guided bias, sampling, commit)
        # up to the sampled ids' copy, and the wait in that copy; and the
        # scheduler thread's CPU seconds over the launch (the rest of the
        # launch's wall time it waited for the GIL or a core)
        self.decode_launch_seconds = 0.0
        self.decode_sync_seconds = 0.0
        self.decode_launch_cpu_seconds = 0.0
        # per-row sampling params on the device, updated only at admission
        self._temps = torch.zeros((max_slots,), dtype=torch.float32,
                                  device=self.device)
        self._topks = torch.zeros((max_slots,), dtype=torch.int32,
                                  device=self.device)
        # guided decoding: per-slot host-side FSM and its current state
        self._guided_fsm: dict[int, object] = {}
        self._guided_state: dict[int, int] = {}
        self.max_prefills_per_step = max(1, int(max_prefills_per_step))
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._free = list(range(max_slots))
        self._by_slot: dict[int, _Request] = {}
        self._waiting: queue.SimpleQueue = queue.SimpleQueue()
        self._backlog: list = []  # paged: admitted-later queue (page pressure)
        self._streaming: list = []  # PD: slot granted, pages still arriving
        self._rid = itertools.count()
        self._work = threading.Event()
        self._stop = False
        self._error: BaseException | None = None
        # cancellation plane: abort_request() rids land in _abort_log, in
        # call order; the scheduler applies the agreed ones at the top of
        # its next pass. Rids whose request is still in _waiting stay in
        # _abort_pending (stamped with the pass's clock) until _admit pops
        # the request; stale ones age out.
        self._abort_pending: dict[int, float] = {}
        self.aborts = 0
        # what the engine has received (submissions, aborts), agreed at the
        # top of each pass: under a mesh, the counts every rank has
        self._submitted = 0
        self._taken = 0
        self._agreed_submitted = 0
        self._abort_log: list = []
        self._agreed_aborts = 0
        self._count_lock = threading.Lock()
        self._now = time.time()  # the pass's clock (agreed under a mesh)
        # device-trace hook (start_profile): while on, the scheduler appends
        # (phase, start_ns, end_ns) of its phases to _spans; None when off
        self._spans: list | None = None
        self._span_open: tuple | None = None  # (phase, start_ns)
        self._spans_dropped = 0
        self._prof = None        # the running torch.profiler
        self._prof_t0 = 0
        self._prof_start_s = 0.0  # the scheduler's seconds in its start
        self._prof_req: tuple | None = None   # (command, done, box)
        self._prof_lock = threading.Lock()    # one caller at a time
        self._prof_hand = threading.Lock()    # _prof_req's hand-off
        # the last slice's result, kept until the next start: a stop with
        # no profile on returns it (a slice the cap ended, or one whose
        # caller gave up waiting)
        self._prof_result: dict | None = None
        self._init_phase_metrics()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine")
        self._thread.start()

    # ---------------------------------------------------------------- public

    @classmethod
    def from_config(cls, llm_config) -> "LLMEngine":
        """Single construction point (the servers' and batch paths' entry)."""
        ek = dict(llm_config.engine_kwargs)
        cfg, params = llm_config.build_model(ek.get("device"))
        lora_cfg = getattr(llm_config, "lora_config", None)
        return cls(cfg, params,
                   max_slots=ek.get("max_slots", 8),
                   max_len=ek.get("max_len", cfg.max_seq_len),
                   min_bucket=ek.get("min_bucket", 32),
                   seed=ek.get("seed", 0),
                   kv_layout=ek.get("kv_layout", "slot"),
                   page_size=ek.get("page_size", 64),
                   num_pages=ek.get("num_pages"),
                   max_prefills_per_step=ek.get("max_prefills_per_step", 2),
                   enable_prefix_cache=ek.get("enable_prefix_cache", False),
                   prefill_chunk=ek.get("prefill_chunk"),
                   speculative_k=ek.get("speculative_k", 0),
                   ngram_size=ek.get("ngram_size", 2),
                   attn_impl=ek.get("attn_impl", "auto"),
                   mesh=ek.get("mesh"),
                   max_loras=ek.get(
                       "max_loras",
                       lora_cfg.max_num_adapters_per_replica
                       if lora_cfg else 0),
                   lora_rank=ek.get(
                       "lora_rank", lora_cfg.lora_rank if lora_cfg else 8),
                   device=ek.get("device"))

    def _init_phase_metrics(self) -> None:
        """Serving-phase instrumentation, resolved once per engine: the
        queue wait, the prefill, the slot admission wait and the
        inter-token gap (Serve's ``ray_tpu_llm_engine_phase_seconds``), and
        for the paged layout the decode step's wall time by attention impl.
        None when ``serve_metrics`` is off."""
        self._phase_admit = self._phase_gap = self._step_obs = None
        self._phase_queue = self._phase_prefill = None
        try:
            from ray_tpu_torch.serve import request_context as _rc
            from ray_tpu_torch.util import metrics as met

            self._phase_admit = _rc.phase_observer(_rc.ENGINE_PHASE,
                                                   "admission_wait")
            self._phase_gap = _rc.phase_observer(_rc.ENGINE_PHASE,
                                                 "inter_token")
            self._phase_queue = _rc.phase_observer(_rc.ENGINE_PHASE,
                                                   "queue_wait")
            self._phase_prefill = _rc.phase_observer(_rc.ENGINE_PHASE,
                                                     "prefill")
            if self.kv_layout == "paged" and _rc.metrics_enabled():
                h = met.get_or_create(
                    met.Histogram, "ray_tpu_llm_decode_step_seconds",
                    "paged decode step wall time (device step + sampling "
                    "sync) by attention impl (ragged|gather)",
                    boundaries=[0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                                0.05, 0.1, 0.25, 0.5, 1.0],
                    tag_keys=("impl",))
                self._step_obs = h.bind({"impl": self.attn_impl})
        except Exception as e:  # metrics must never gate the engine's boot
            logger.debug("engine phase metrics unavailable: %r", e)
            self._phase_admit = self._phase_gap = self._step_obs = None
            self._phase_queue = self._phase_prefill = None

    def _check_alive(self):
        if self._error is not None:
            raise RuntimeError("engine scheduler died") from self._error
        if self._stop:
            raise RuntimeError("engine is shut down")

    def load_lora(self, name: str, weights: dict, *,
                  alpha: float | None = None) -> None:
        """Load adapter `name` into a free bank slot. `weights` are
        layer-stacked host arrays {"A_q": [L, E, r], "B_q": [L, r, H, Dh],
        "A_v": [L, E, r], "B_v": [L, r, Hkv, Dh]} (missing targets stay
        zero; under a mesh every rank loads the full adapter and keeps its
        heads' B). Scale is alpha/r, 1.0 when alpha is None."""
        if self.lora_bank is None:
            raise ValueError("engine built without max_loras")
        if self.mesh is not None:  # B factors: this rank's heads
            tp = mesh_shape(self.mesh)[MESH_AXIS_TP]
            r = axis_rank(self.mesh, MESH_AXIS_TP)
            weights = dict(weights)
            for key in ("B_q", "B_v"):
                if key in weights:
                    w = np.asarray(weights[key])
                    n = w.shape[2] // tp
                    weights[key] = w[:, :, r * n:(r + 1) * n]
        with self._lora_lock:
            if name in self._lora_ids:
                raise ValueError(f"lora {name!r} already loaded")
            if not self._lora_free:
                raise RuntimeError(
                    f"no free lora slots (max_loras={self.max_loras}); "
                    f"unload one of {sorted(self._lora_ids)}")
            idx = self._lora_free.pop()
            bank = dict(self.lora_bank)
            # validate every shape before writing any: a partial write then
            # a raise would leave stale weights in a slot the free list
            # hands to the next adapter
            for key in ("A_q", "B_q", "A_v", "B_v"):
                if key in weights:
                    want = bank[key].shape[0:1] + bank[key].shape[2:]
                    got = np.asarray(weights[key]).shape
                    if got != tuple(want):
                        self._lora_free.append(idx)
                        raise ValueError(
                            f"lora {name!r} {key} shape {got} != "
                            f"{tuple(want)} (rank {self.lora_rank}, "
                            "layer-stacked)")
            try:
                # writes go into clones: the bank a step in flight holds,
                # and self.lora_bank on a failure, stay whole
                for key in ("A_q", "B_q", "A_v", "B_v"):
                    if key in weights:
                        leaf = bank[key].clone()
                        leaf[:, idx] = torch.as_tensor(
                            np.asarray(weights[key]), dtype=leaf.dtype,
                            device=leaf.device)
                        bank[key] = leaf
                scale = 1.0 if alpha is None else float(alpha) / self.lora_rank
                bank["scale"] = bank["scale"].clone()
                bank["scale"][idx] = scale
            except Exception:
                self._lora_free.append(idx)
                raise
            self.lora_bank = bank
            self._lora_ids[name] = idx
            self._lora_refs[idx] = 0

    def unload_lora(self, name: str) -> None:
        """Free `name`'s bank slot. Refuses while requests using it are
        live (submitted and not yet finished)."""
        if self.lora_bank is None:
            raise KeyError(f"lora {name!r} not loaded")
        with self._lora_lock:
            if name not in self._lora_ids:
                raise KeyError(f"lora {name!r} not loaded")
            idx = self._lora_ids[name]
            if self._lora_refs.get(idx, 0) > 0:
                raise RuntimeError(
                    f"lora {name!r} has {self._lora_refs[idx]} live requests")
            # zero into clones first, as load_lora writes
            bank = dict(self.lora_bank)
            for key in ("A_q", "B_q", "A_v", "B_v"):
                bank[key] = bank[key].clone()
                bank[key][:, idx] = 0.0
            bank["scale"] = bank["scale"].clone()
            bank["scale"][idx] = 0.0
            self.lora_bank = bank
            del self._lora_ids[name]
            self._lora_refs.pop(idx, None)
            self._lora_free.append(idx)

    def list_loras(self) -> list:
        return sorted(self._lora_ids) if self.lora_bank is not None else []

    def _lora_release(self, req: _Request) -> None:
        if req.lora_idx and not req.lora_released:
            req.lora_released = True
            with self._lora_lock:
                self._lora_refs[req.lora_idx] = max(
                    0, self._lora_refs.get(req.lora_idx, 1) - 1)

    def submit(self, token_ids: list, params: SamplingParams | None = None,
               *, lora: str | None = None,
               deadline_ts: float = 0.0) -> _Request:
        self._check_alive()
        params = params or SamplingParams()
        if params.guided is not None:
            if self.speculative_k:
                raise ValueError(
                    "guided decoding and speculative decoding cannot be "
                    "combined (drafts would have to be FSM-checked per "
                    "position; build the engine with speculative_k=0)")
            if params.guided.vocab_size != self.cfg.vocab_size:
                raise ValueError(
                    f"guided FSM vocab {params.guided.vocab_size} != model "
                    f"vocab {self.cfg.vocab_size}")
        token_ids = list(token_ids)
        if not token_ids:
            raise ValueError("empty prompt: at least one token is required")
        limit = self.max_len - params.max_tokens - 1
        if limit <= 0:
            raise ValueError("max_tokens leaves no room for the prompt")
        token_ids = token_ids[-limit:]
        if self.kv_layout == "paged":
            need = self._pages_needed(len(token_ids),
                                      self._bucket(len(token_ids)),
                                      params.max_tokens)
            if need > self.num_pages - 1:  # page 0 is scratch
                raise ValueError(
                    f"request needs {need} KV pages but the pool only has "
                    f"{self.num_pages - 1}; raise num_pages or shrink "
                    f"prompt/max_tokens")
        lora_idx = 0
        if lora is not None:
            if self.lora_bank is None:
                raise ValueError("engine built without max_loras")
            # resolve and take the reference atomically with respect to
            # load/unload, so the index cannot be reused in between
            with self._lora_lock:
                if lora not in self._lora_ids:
                    raise KeyError(f"lora {lora!r} not loaded "
                                   f"(loaded: {sorted(self._lora_ids)})")
                lora_idx = self._lora_ids[lora]
                self._lora_refs[lora_idx] += 1
        req = _Request(next(self._rid), token_ids, params,
                       history=list(token_ids), lora_idx=lora_idx,
                       deadline_ts=float(deadline_ts or 0.0))
        req.submitted_ts = time.time()
        req.trace_ctx = tracing.current_context()
        self._enqueue(req)
        return req

    def _enqueue(self, req: _Request) -> None:
        with self._count_lock:
            self._waiting.put(req)
            self._submitted += 1
        self._work.set()

    def submit_prefilled(self, k=None, v=None, length: int = 0,
                         first_token: int = 0,
                         params: SamplingParams | None = None, *,
                         k_pages: list | None = None,
                         v_pages: list | None = None,
                         kv_stream=None,
                         deadline_ts: float = 0.0) -> _Request:
        """Admit a sequence whose prefill ran elsewhere (PD disaggregation).

        Three forms:
        - whole-array: k/v are [L, T, Hkv, Dh] host arrays or tensors for
          the prompt prefix;
        - page-granular: k_pages/v_pages are ordered lists of
          [L, page_size, Hkv, Dh] pages (the shm transfer plane's unit).
          On the paged layout each page is written into a granted pool page
          (``write_kv_pages``) and the row activated (``activate_slot``):
          no whole-bucket array is assembled;
        - streamed: kv_stream is a kv_transfer.KVPageStream the transfer
          plane is still feeding. The slot and its pages are granted now
          and each page is adopted as it arrives; the decode loop keeps
          stepping other slots meanwhile, and the row activates on the
          last page. A transfer failure is a per-request error; the slot
          and its pages are reclaimed.

        The caller already holds ``first_token`` (it counts against
        max_tokens); the request yields the tokens after it.

        Under ``mesh=`` every rank submits the same request with the full
        K/V (all n_kv_heads heads), as with ``submit``; each rank keeps its
        own n_kv_heads/tp heads, the split ``shard_params_tp`` makes of
        wk/wv. A stream has one reader: tp rank 0's stream is read, and
        each page it delivers reaches every rank through the tp group.
        The other ranks pass a stream of the same ``n_pages`` and
        ``page_size`` that nothing needs to feed.
        """
        self._check_alive()
        params = params or SamplingParams()
        paged_form = k_pages is not None or v_pages is not None
        if kv_stream is not None:
            if paged_form or k is not None or v is not None:
                raise ValueError(
                    "pass kv_stream alone, not with k/v or k_pages/v_pages")
            P = int(kv_stream.page_size)
            if self.kv_layout == "paged" and P != self.page_size:
                raise ValueError(
                    f"streamed page size {P} != engine page_size "
                    f"{self.page_size}: prefill and decode pools must agree")
            bucket = int(kv_stream.n_pages) * P
        elif paged_form:
            if k is not None or v is not None:
                raise ValueError(
                    "pass either k/v arrays or k_pages/v_pages, not both")
            if not k_pages or not v_pages or len(k_pages) != len(v_pages):
                raise ValueError(
                    "k_pages and v_pages must be equal-length non-empty "
                    "lists of [L, page_size, Hkv, Dh] pages")
            P = k_pages[0].shape[1]
            if any(p.shape[1] != P for p in list(k_pages) + list(v_pages)):
                raise ValueError("transferred pages have mixed page sizes")
            if self.kv_layout == "paged" and P != self.page_size:
                raise ValueError(
                    f"transferred page size {P} != engine page_size "
                    f"{self.page_size}: prefill and decode pools must agree")
            bucket = len(k_pages) * P
        else:
            if k is None or v is None:
                raise ValueError(
                    "submit_prefilled needs k/v arrays, k_pages/v_pages, "
                    "or kv_stream")
            bucket = k.shape[1]
        if bucket > self.max_len:
            raise ValueError(
                f"transferred prefix bucket {bucket} exceeds engine "
                f"max_len {self.max_len}")
        if self.kv_layout == "paged":
            if bucket % self.page_size:
                raise ValueError(
                    f"transferred prefix bucket {bucket} is not a "
                    f"multiple of page_size {self.page_size}: configure the "
                    f"prefill side with min_bucket >= page_size")
            need = self._pages_needed(int(length), bucket, params.max_tokens)
            if need > self.num_pages - 1:
                raise ValueError(
                    f"request needs {need} KV pages but the pool only has "
                    f"{self.num_pages - 1}")
        if int(length) + params.max_tokens > self.max_len:
            raise ValueError(
                f"prefix length {int(length)} + max_tokens {params.max_tokens} "
                f"does not fit engine max_len {self.max_len}")
        req = _Request(next(self._rid), [], params,
                       deadline_ts=float(deadline_ts or 0.0))
        req.submitted_ts = time.time()
        pack = {"length": int(length), "first_token": int(first_token)}
        if kv_stream is not None:
            req.kv_stream = kv_stream
            # feed()/finish()/fail() wake the scheduler, so a parked loop
            # adopts new pages at once instead of on its poll tick
            kv_stream._wake = self._work.set
        elif paged_form:
            pack.update(k_pages=list(k_pages), v_pages=list(v_pages))
        else:
            pack.update(k=k, v=v)
        req.kv_pack = pack
        req.generated = 1  # the transferred first token counts
        self._enqueue(req)
        return req

    def generate(self, token_ids: list, params: SamplingParams | None = None,
                 *, lora: str | None = None) -> list:
        """Blocking: returns the generated token ids."""
        return list(self.stream(token_ids, params, lora=lora))

    def stream(self, token_ids: list, params: SamplingParams | None = None,
               *, lora: str | None = None):
        """Yields token ids as they are produced."""
        req = self.submit(token_ids, params, lora=lora)
        yield from _iter_request(req)

    def abort_request(self, rid: int) -> None:
        """Cancel an in-flight request by rid: the scheduler reclaims its
        slot and pages at the top of its next pass, and the caller's
        iterator raises RequestCancelledError. Thread-safe; an unknown or
        finished rid is a no-op that ages out."""
        with self._count_lock:
            self._abort_log.append(int(rid))
        self._work.set()

    def shutdown(self):
        self._stop = True
        self._work.set()
        self._thread.join(timeout=5.0)
        self._drain_all(None)

    def _drain_all(self, error: BaseException | None):
        """Unblock every waiting caller: end-of-stream, or the failure."""
        marker = _EngineError(error) if error is not None else _SENTINEL
        for req in (list(self._by_slot.values()) + self._backlog
                    + self._prefilling + self._streaming):
            self._lora_release(req)
            req.out_queue.put(marker)
        self._backlog.clear()
        self._prefilling.clear()
        self._streaming.clear()
        while True:
            try:
                req = self._waiting.get_nowait()
            except queue.Empty:
                break
            self._lora_release(req)
            req.out_queue.put(marker)

    # ------------------------------------------------------------- scheduler

    def _bucket(self, n: int) -> int:
        return bucket_for(n, self.buckets[0], self.max_len)

    def _pages_needed(self, prompt_len: int, bucket: int, max_tokens: int) -> int:
        """All pages this sequence will EVER touch, granted up front (no
        mid-flight allocation → no page-starvation deadlock): the prompt
        bucket plus generated positions up to prompt_len + max_tokens."""
        last_pos = min(prompt_len + max_tokens, self.max_len - 1)
        return max(bucket // self.page_size, last_pos // self.page_size + 1)

    # ---------------------------------------------------- prefix cache (paged)

    def _block_hashes(self, tokens: list) -> list:
        """Chain hashes of the prompt's full page_size blocks: h_i commits
        to every token before the block too, so a hit means the whole
        prefix through block i is identical."""
        out = []
        h = b""
        P = self.page_size
        for i in range(len(tokens) // P):
            blk = np.asarray(tokens[i * P:(i + 1) * P], np.int32).tobytes()
            h = hashlib.sha1(h + blk).digest()
            out.append(h)
        return out

    def _reclaimable_pages(self) -> int:
        # stats() reads this from other threads while the scheduler mutates
        # the cache: snapshot first, tolerate a racing resize
        for _ in range(4):
            try:
                pages = list(self._prefix_cache.values())
                break
            except RuntimeError:
                continue
        else:
            return 0
        refs = self._page_refs
        return sum(1 for p in pages if refs.get(p, 0) == 0)

    def _available_pages(self) -> int:
        n = len(self._free_pages)
        if self.enable_prefix_cache:
            n += self._reclaimable_pages()
        return n

    def _alloc_pages(self, need: int) -> list | None:
        """Take pages from the free list, evicting zero-ref cached blocks
        (LRU first) when the list runs short. None = infeasible now."""
        if need > self._available_pages():
            return None
        if need > len(self._free_pages):
            for h in list(self._prefix_cache):
                if len(self._free_pages) >= need:
                    break
                p = self._prefix_cache[h]
                if self._page_refs.get(p, 0) == 0:
                    del self._prefix_cache[h]
                    self._page_refs.pop(p, None)
                    self._page_hash.pop(p, None)
                    self._free_pages.append(p)
        return [self._free_pages.pop() for _ in range(need)]

    def _match_prefix(self, tokens: list, hashes: list) -> int:
        """Longest run of leading cached blocks usable for reuse. The block
        holding the last prompt token is never reused: at least one real
        token must go through prefill to produce the sampling logits."""
        usable = (len(tokens) - 1) // self.page_size
        n_pre = 0
        for i in range(min(usable, len(hashes))):
            if self._prefix_cache.get(hashes[i]) is None:
                break
            self._prefix_cache.move_to_end(hashes[i])  # LRU touch
            n_pre += 1
        return n_pre

    def _register_blocks(self, slot: int, tokens: list, hashes: list,
                         n_pre: int, priv_pages: list) -> None:
        """Make this request's freshly computed full blocks available to
        later prompts: their pages move from private (freed on release) to
        shared (ref-counted, cached)."""
        shared = self._slot_shared.setdefault(slot, [])
        still_private = list(priv_pages)
        for i in range(n_pre, len(tokens) // self.page_size):
            if hashes[i] in self._prefix_cache:
                continue  # someone registered it first; keep ours private
            page = priv_pages[i - n_pre]
            self._prefix_cache[hashes[i]] = page
            self._page_hash[page] = hashes[i]
            self._page_refs[page] = self._page_refs.get(page, 0) + 1
            shared.append(page)
            still_private.remove(page)
        self._slot_pages[slot] = still_private

    def _release_shared(self, slot: int) -> None:
        for p in self._slot_shared.pop(slot, ()):
            # at 0 the page stays cached, reclaimable until eviction needs
            # it (or a new request re-refs it)
            self._page_refs[p] = max(0, self._page_refs.get(p, 0) - 1)

    def _grant_pages(self, need: int) -> list | None:
        """Grant `need` pool pages (evicting zero-ref cached blocks when
        the prefix cache is on), or None when infeasible right now."""
        if self.enable_prefix_cache:
            return self._alloc_pages(need)
        if need > len(self._free_pages):
            return None
        return [self._free_pages.pop() for _ in range(need)]

    # ------------------------------------------------------------- admission

    def _set_row_sampling(self, slot: int, params: SamplingParams):
        self._temps[slot] = float(params.temperature)
        self._topks[slot] = int(params.top_k)
        if params.guided is not None:
            self._guided_fsm[slot] = params.guided
            # the first token was sampled under the start state's mask; its
            # state advance happens in _emit
            self._guided_state[slot] = params.guided.start

    def _sample_first(self, req: _Request, logits):
        """First-token sampling after a prefill, under the guided FSM's
        start state (decode steps apply per-slot biases)."""
        g = req.params.guided
        if g is not None:
            logits = logits + torch.as_tensor(
                _guided.bias_row(g, g.start, remaining=req.params.max_tokens),
                device=logits.device)
        return self._agree(decoding.sample(
            logits[None, :], self._gen, req.params.temperature,
            req.params.top_k))

    def _agree(self, toks):
        """Sampled token ids, the same on every rank: tp rank 0's."""
        if self.mesh is None:
            return toks
        return collectives.broadcast(toks, MESH_AXIS_TP, root=0)

    def _bind_slot(self, req: _Request, slot: int, length: int) -> None:
        """Slot activation bookkeeping shared by every admission path:
        sampling params, LoRA row, request registry, and the row's device
        length mirrored host-side for the ragged step's page bound."""
        req.length0 = int(length)
        req.admitted_ts = time.time()
        if self._phase_admit is not None and req.submitted_ts:
            # submit → slot bind: the waiting queue, the page-pressure
            # backlog and (PD) the page pull
            self._phase_admit.observe(req.admitted_ts - req.submitted_ts)
        self._set_row_sampling(slot, req.params)
        if self.lora_bank is not None:
            self._slot_lora[slot] = req.lora_idx
        self._by_slot[slot] = req

    def _insert(self, req: _Request, slot: int, kv, length: int,
                first_token) -> bool:
        """Layout-dispatching insertion. False when the paged pool cannot
        host the sequence right now (the caller backlogs)."""
        if self.kv_layout == "paged":
            need = self._pages_needed(length, kv["k"].shape[1],
                                      req.params.max_tokens)
            pages = self._grant_pages(need)
            if pages is None:
                return False
            self._slot_pages[slot] = pages
            padded_pages = np.zeros((self.max_pages_per_seq,), np.int32)
            padded_pages[:need] = pages
            dp.insert_sequence_paged(self.state, slot, kv, length,
                                     first_token, padded_pages, self.cfg)
        else:
            decoding.insert_sequence(self.state, slot, kv, length,
                                     first_token, self.cfg)
        self._bind_slot(req, slot, length)
        return True

    def _next_waiting(self):
        if self._backlog:
            return self._backlog.pop(0)
        if self._taken >= self._agreed_submitted:
            return None  # not agreed yet (under a mesh: not on every rank)
        try:
            req = self._waiting.get_nowait()
        except queue.Empty:
            return None
        self._taken += 1
        return req

    def _tokens(self, toks: list, bucket: int):
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :len(toks)] = toks
        return torch.as_tensor(padded, device=self.device)

    def _prefix_kv(self, pages: list):
        """The cached prefix of `pages` out of the pool, the id list padded
        to a power of two with scratch page 0 (masked by prefix_len)."""
        ids = np.zeros((_pow2_at_least(len(pages)),), np.int32)
        ids[:len(pages)] = pages
        return dp.gather_prefix_pages(self.state["kp"], self.state["vp"],
                                      ids)

    def _admit(self):
        admitted = 0
        while self._free and admitted < self.max_prefills_per_step:
            if self._spans is not None:
                self._phase("admit")
            req = self._next_waiting()
            if req is None:
                return
            if self._cancel_at_admission(req):
                continue
            slot = self._free.pop()
            req.slot = slot
            if req.kv_pack is not None:
                if req.generated >= req.params.max_tokens:
                    # budget already spent by the transferred first token
                    self._free.append(slot)
                    self._lora_release(req)
                    req.out_queue.put(_SENTINEL)
                    continue
                if req.kv_stream is not None:
                    # streamed admission: slot and pages granted now, pages
                    # adopted as they arrive (_drain_streams). No prefill
                    # compute, so it does not count against the budget
                    if not self._admit_stream(req, slot):
                        self._free.append(slot)
                        self._backlog.append(req)
                        return  # page pressure: stop admitting this round
                    self._observe_queue_wait(req)
                    continue
                if not self._insert_transferred(req, slot):
                    self._free.append(slot)
                    self._backlog.append(req)
                    return  # page pressure: stop admitting this round
                self._observe_queue_wait(req)
                admitted += 1
                continue
            if self._spans is not None:
                self._phase("prefill")
            req.started_ts = time.time()
            t0 = time.perf_counter()
            if self.kv_layout == "paged" and (self.enable_prefix_cache
                                              or self.prefill_chunk):
                first_id = self._admit_cached(req, slot)
                if first_id is None:
                    self._free.append(slot)
                    self._backlog.append(req)
                    return  # page pressure: stop admitting this round
                self.prefill_seconds += time.perf_counter() - t0
                admitted += 1
                if first_id != -1:  # -1 = staged for chunked prefill
                    self._first_token(req, first_id)
                continue
            n = len(req.tokens)
            bucket = self._bucket(n)
            # cheap feasibility check before paying for the prefill
            if self.kv_layout == "paged" and self._pages_needed(
                    n, bucket, req.params.max_tokens) > len(self._free_pages):
                self._free.append(slot)
                self._backlog.append(req)
                return
            logits, kv = decoding.prefill(
                self.params, self._tokens(req.tokens, bucket), n, self.cfg,
                lora_bank=self.lora_bank, lora_idx=req.lora_idx)
            self.prefills += 1
            first = self._sample_first(req, logits)
            first_id = int(first[0])  # syncs: the prefill is done here
            if not self._insert(req, slot, kv, n, first[0]):
                self._free.append(slot)
                self._backlog.append(req)
                return
            self.prefill_seconds += time.perf_counter() - t0
            admitted += 1
            self._first_token(req, first_id)

    def _observe_queue_wait(self, req: _Request) -> None:
        """A PD admission's submit → the pass that grants its slot."""
        if self._phase_queue is not None:
            self._phase_queue.observe(time.time() - req.submitted_ts)

    def _first_token(self, req: _Request, token_id: int) -> None:
        """Emit a prefill's first token; its stamp ends the request's
        queue_wait and prefill phases, observed here and, for a sampled
        request, emitted as its llm:queue_wait and llm:prefill spans."""
        now = time.time()
        if self._spans is not None:
            self._phase("emit")
        if self._phase_queue is not None:
            self._phase_queue.observe(req.started_ts - req.submitted_ts)
            self._phase_prefill.observe(now - req.started_ts)
        if req.trace_ctx is not None:
            tracing.emit_span_for(req.trace_ctx, "llm:queue_wait",
                                  req.submitted_ts, req.started_ts,
                                  rid=req.rid)
            tracing.emit_span_for(req.trace_ctx, "llm:prefill",
                                  req.started_ts, now, rid=req.rid,
                                  prompt_tokens=len(req.tokens))
        self._emit(req, token_id, now)

    # ------------------------------------------------------- PD admission

    def _pool_dtype(self) -> torch.dtype:
        return self.state["k" if self.kv_layout == "slot" else "kp"].dtype

    def _pool_tensor(self, x, local: bool = False) -> torch.Tensor:
        """A transferred host array or tensor ([L, T, Hkv, Dh], a whole
        prefix or one page) on the cache's device and dtype: one
        host-to-device copy. Under a mesh, this rank's contiguous
        n_kv_heads/tp heads of it; `local`: x holds only those heads
        already (a streamed page scattered from tp rank 0)."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        if self.mesh is not None:
            hkv = self.cfg.kv_heads
            n = hkv // mesh_shape(self.mesh)[MESH_AXIS_TP]
            want = n if local else hkv
            if t.dim() != 4 or t.shape[2] != want:
                raise ValueError(
                    f"under mesh= every rank takes the full transferred KV "
                    f"([L, T, {hkv}, Dh]), got shape {tuple(t.shape)}")
            if not local:
                r = axis_rank(self.mesh, MESH_AXIS_TP)
                t = t[:, :, r * n:(r + 1) * n]
        return t.to(self.device, self._pool_dtype())

    def _adopt_pages(self, pages: list, items, local: bool = False) -> None:
        """Write transferred (index, k_page, v_page) items into the granted
        pool `pages` (write_kv_pages, one [L, P, Hkv, Dh] page at a time)."""
        for i, kp, vp in items:
            dp.write_kv_pages(self.state,
                              {"k": self._pool_tensor(kp, local),
                               "v": self._pool_tensor(vp, local)},
                              [pages[i]])

    def _grant_transferred(self, req: _Request, slot: int,
                           n_pages: int) -> bool:
        """Grant `slot` every pool page a transferred sequence of `n_pages`
        prefix pages will ever touch; False when the pool cannot now."""
        pages = self._grant_pages(self._pages_needed(
            req.kv_pack["length"], n_pages * self.page_size,
            req.params.max_tokens))
        if pages is None:
            return False
        self._slot_pages[slot] = pages
        return True

    def _activate_transferred(self, req: _Request, slot: int) -> None:
        """Turn a row whose transferred pages are all in the pool live."""
        pack = req.kv_pack
        granted = self._slot_pages[slot]
        row = np.zeros((self.max_pages_per_seq,), np.int32)
        row[:len(granted)] = granted
        dp.activate_slot(self.state, slot, row, pack["length"],
                         pack["first_token"])
        self._bind_slot(req, slot, pack["length"])

    def _insert_transferred(self, req: _Request, slot: int,
                            local: bool = False) -> bool:
        """Insert a kv_pack from a prefill elsewhere. Pages on the paged
        layout are adopted into granted pool pages; whole arrays, and pages
        on the slot layout (assembled on the host), take _insert. False
        when the pool cannot host the sequence now (the caller
        backlogs). `local`: see _pool_tensor."""
        pack = req.kv_pack
        if "k_pages" in pack:
            if self.kv_layout == "paged":
                if not self._grant_transferred(req, slot,
                                               len(pack["k_pages"])):
                    return False
                self._adopt_pages(self._slot_pages[slot],
                                  zip(itertools.count(), pack["k_pages"],
                                      pack["v_pages"]), local)
                self._activate_transferred(req, slot)
                return True
            # the slot layout has no page pool: assemble the bucket
            kv = {name: torch.cat([torch.as_tensor(p)
                                   for p in pack[f"{name}_pages"]], dim=1)
                  for name in ("k", "v")}
        else:
            kv = {"k": pack["k"], "v": pack["v"]}
        kv = {name: self._pool_tensor(x, local) for name, x in kv.items()}
        return self._insert(req, slot, kv, pack["length"],
                            pack["first_token"])

    def _admit_stream(self, req: _Request, slot: int) -> bool:
        """Streamed admission: grant the slot and every page the sequence
        will ever need now; pages are written as the transfer delivers
        them (_drain_streams) and the row activates on the last one. False
        when the pool cannot host the sequence yet (the caller backlogs;
        arrived pages keep buffering in the stream)."""
        if self.kv_layout == "paged" and not self._grant_transferred(
                req, slot, req.kv_stream.n_pages):
            return False
        req.slot = slot
        req.pf_done = 0
        self._streaming.append(req)
        return True

    def _fail_stream(self, req: _Request, err) -> None:
        """Reclaim a streamed admission whose transfer died: the slot was
        granted but never activated, so only host bookkeeping unwinds."""
        if req in self._streaming:
            self._streaming.remove(req)
        if self.kv_layout == "paged":
            self._free_pages.extend(self._slot_pages.pop(req.slot, ()))
        self._free.append(req.slot)
        self._lora_release(req)
        if not isinstance(err, BaseException):
            err = RuntimeError(str(err))
        req.out_queue.put(_RequestError(err))

    def _drain_streams(self) -> bool:
        """Adopt every page that arrived since the last pass into its slot's
        granted pages, and activate the rows whose last page landed. Runs
        between decode steps. True if anything moved."""
        progressed = False
        local = self.mesh is not None  # _take_streamed scatters the heads
        for req, (err, ready) in zip(list(self._streaming),
                                     self._take_streamed()):
            st = req.kv_stream
            if err is not None:
                self._fail_stream(req, err)
                progressed = True
                continue
            try:
                if ready:
                    progressed = True
                    if self.kv_layout == "paged":
                        self._adopt_pages(self._slot_pages[req.slot], ready,
                                          local)
                    else:
                        # the slot layout has no page pool: buffer, then
                        # assemble at completion
                        kps = req.kv_pack.setdefault(
                            "k_pages", [None] * st.n_pages)
                        vps = req.kv_pack.setdefault(
                            "v_pages", [None] * st.n_pages)
                        for i, kp, vp in ready:
                            kps[i], vps[i] = kp, vp
                    req.pf_done += len(ready)
                if req.pf_done >= st.n_pages:
                    self._streaming.remove(req)
                    if self.kv_layout == "paged":
                        self._activate_transferred(req, req.slot)
                    else:
                        req.kv_stream = None
                        self._insert_transferred(req, req.slot, local)
                    progressed = True
            except Exception as e:  # noqa: BLE001 — a malformed page must
                # fail THIS request, not the scheduler (engine death would
                # drop every other in-flight request)
                self._fail_stream(req, e)
                progressed = True
        return progressed

    def _read_stream(self, st, stacked: bool = False):
        """(error or None, ready pages) of one stream. `stacked`: each page
        as (index, one [2, L, P, Hkv, Dh] tensor in the pool's dtype on the
        engine's device), its shape checked: a malformed page fails the
        request."""
        err = st.take_error()
        if err is not None:
            return err, []
        ready = st.take_ready()
        if not stacked:
            return None, ready
        cfg = self.cfg
        want = (2, cfg.n_layers, st.page_size, cfg.kv_heads, cfg.head_dim)
        pages = []
        try:
            for i, kp, vp in ready:
                pair = torch.stack([torch.as_tensor(kp), torch.as_tensor(vp)])
                if tuple(pair.shape) != want:
                    raise ValueError(f"transferred page has shape "
                                     f"{tuple(pair.shape[1:])}, expected "
                                     f"{want[1:]}")
                pages.append((int(i), pair.to(self.device, self._pool_dtype())))
        except Exception as e:  # noqa: BLE001 — fails this request only
            return e, []
        return None, pages

    def _take_streamed(self) -> list:
        """(error or None, ready pages) for each streamed admission, in
        ``_streaming``'s order. Under a mesh tp rank 0 reads its streams
        and the other ranks get what it read through the tp group: a header
        (per request: failed, pages, message bytes), the page indices, the
        failures (class and message), then each page, of which every rank
        receives only its own n_kv_heads/tp heads ([2, L, P, Hkv/tp, Dh],
        one scatter a page). ``_streaming`` is the same on every rank
        (admission is agreed), so every rank issues the same collectives,
        and a failed stream fails with the same exception class on every
        rank."""
        reqs = list(self._streaming)
        if self.mesh is None:
            return [self._read_stream(req.kv_stream) for req in reqs]
        root = axis_rank(self.mesh, MESH_AXIS_TP) == 0

        def from_root(values: list, n: int) -> list:
            t = torch.tensor(values if root else [0] * n, dtype=torch.int64,
                             device=self.device)
            return (collectives.broadcast(t, MESH_AXIS_TP, root=0).tolist()
                    if n else [])

        taken = [self._read_stream(req.kv_stream, stacked=True) if root
                 else (None, []) for req in reqs]
        msgs = [b"" if e is None else
                f"{type(e).__module__}.{type(e).__qualname__}\n{e}".encode()
                for e, _ in taken]
        head = from_root([x for (e, p), m in zip(taken, msgs)
                          for x in (e is not None, len(p), len(m))],
                         3 * len(reqs))
        failed, counts, sizes = head[0::3], head[1::3], head[2::3]
        idx = iter(from_root([i for _, p in taken for i, _ in p],
                             sum(counts)))
        blob = bytes(from_root(list(b"".join(msgs)), sum(sizes)))
        cfg, dt = self.cfg, self._pool_dtype()
        tp = mesh_shape(self.mesh)[MESH_AXIS_TP]
        out, pos = [], 0
        for req, (err, pages), bad, n, m in zip(reqs, taken, failed, counts,
                                                sizes):
            msg, pos = blob[pos:pos + m].decode(), pos + m
            if bad:
                out.append((err if root else _rebuilt_error(msg), []))
                continue
            # [tp, 2, L, P, Hkv/tp, Dh]: rank j's heads are chunk j; off
            # root, a template that holds no page
            shape = (tp, 2, cfg.n_layers, req.kv_stream.page_size,
                     cfg.kv_heads // tp, cfg.head_dim)
            ready = []
            for k in range(n):
                chunks = (pages[k][1].unflatten(3, (tp, shape[4]))
                          .movedim(3, 0) if root else torch.empty(
                              (), dtype=dt, device=self.device).expand(shape))
                pair = collectives.scatter(chunks, MESH_AXIS_TP, root=0)
                ready.append((next(idx), pair[0], pair[1]))
            out.append((None, ready))
        return out

    def _admit_cached(self, req: _Request, slot: int):
        """Paged admission with hash-block prefix reuse and/or chunking.
        Returns the first sampled token id, -1 when the prompt was staged
        for chunked prefill, or None when the page pool cannot host the
        sequence right now (the caller backlogs)."""
        tokens = req.tokens
        n = len(tokens)
        P = self.page_size
        hashes = self._block_hashes(tokens)
        n_pre = self._match_prefix(tokens, hashes)
        # shrink the reused prefix if the suffix bucket's roundup would
        # overflow the block table
        while n_pre > 0 and (n_pre + self._bucket(n - n_pre * P) // P
                             > self.max_pages_per_seq):
            n_pre -= 1
        pre_len = n_pre * P
        suffix = tokens[pre_len:]
        suf_bucket = self._bucket(len(suffix))
        last_pos = min(n + req.params.max_tokens, self.max_len - 1)
        total_pages = max(n_pre + suf_bucket // P, last_pos // P + 1)
        pre_pages = [self._prefix_cache[hashes[i]] for i in range(n_pre)]
        chunk = self.prefill_chunk
        staged = chunk is not None and len(suffix) > chunk
        if staged:
            # page need covers each chunk's bucket span (the last partial
            # chunk pads to its own bucket); committed only if staging goes
            # ahead, the whole-prompt fallback keeps its own need
            rem = len(suffix) % chunk
            tail_bucket = self._bucket(rem) if rem else 0
            span = pre_len + (len(suffix) - rem) + tail_bucket
            staged_pages = max(span // P, total_pages)
            if staged_pages > self.max_pages_per_seq:
                staged = False  # bucket roundup overflow: whole prompt
            else:
                total_pages = staged_pages
        # pin the matched blocks before allocating: eviction must not take
        # them
        for p in pre_pages:
            self._page_refs[p] = self._page_refs.get(p, 0) + 1
        priv = self._alloc_pages(total_pages - n_pre)
        if priv is None:
            for p in pre_pages:  # unpin; the request is backlogged
                self._page_refs[p] = self._page_refs.get(p, 1) - 1
            return None
        self._slot_shared[slot] = list(pre_pages)
        if self.enable_prefix_cache:
            if n_pre:
                self.prefix_hits += 1
                self.prefix_tokens_reused += pre_len
            else:
                self.prefix_misses += 1
        if staged:
            req.pf_done = pre_len
            req.pf_pages = pre_pages + priv
            req.pf_hashes = hashes
            self._slot_pages[slot] = list(priv)
            self._prefilling.append(req)
            return -1
        toks = self._tokens(suffix, suf_bucket)
        if n_pre:
            k_pre, v_pre = self._prefix_kv(pre_pages)
            logits, kv = dp.prefill_with_prefix(
                self.params, toks, k_pre, v_pre, pre_len, len(suffix),
                self.cfg)
            self.prefix_prefills += 1
        else:
            logits, kv = decoding.prefill(self.params, toks, len(suffix),
                                          self.cfg)
            self.prefills += 1
        first = self._sample_first(req, logits)
        block_row = np.zeros((self.max_pages_per_seq,), np.int32)
        block_row[:n_pre] = pre_pages
        block_row[n_pre:n_pre + len(priv)] = priv
        dp.insert_sequence_paged_prefix(
            self.state, slot, kv, np.asarray(priv[:suf_bucket // P], np.int32),
            block_row, n, first[0], self.cfg)
        self._slot_pages[slot] = list(priv)
        self._bind_slot(req, slot, n)
        if self.enable_prefix_cache:
            self._register_blocks(slot, tokens, hashes, n_pre, priv)
        return int(first[0])

    def _prefill_step(self):
        """Run one chunk of the oldest staged prefill (between decode
        steps, so running requests keep emitting during a long
        admission)."""
        t0 = time.perf_counter()
        req = self._prefilling[0]
        tokens = req.tokens
        P = self.page_size
        done = req.pf_done
        chunk_toks = tokens[done:done + self.prefill_chunk]
        is_last = done + len(chunk_toks) >= len(tokens)
        bucket = self._bucket(len(chunk_toks))
        toks = self._tokens(chunk_toks, bucket)
        if done == 0:
            logits, kv = decoding.prefill(self.params, toks, len(chunk_toks),
                                          self.cfg)
            self.prefills += 1
        else:
            k_pre, v_pre = self._prefix_kv(req.pf_pages[:done // P])
            logits, kv = dp.prefill_with_prefix(
                self.params, toks, k_pre, v_pre, done, len(chunk_toks),
                self.cfg)
            self.prefix_prefills += 1
        dp.write_kv_pages(self.state, kv, np.asarray(
            req.pf_pages[done // P:(done + bucket) // P], np.int32))
        req.pf_done = done + len(chunk_toks)
        self.prefill_chunks_run += 1
        if not is_last:
            self.prefill_seconds += time.perf_counter() - t0
            return
        self._prefilling.pop(0)
        n = len(tokens)
        first = self._sample_first(req, logits)
        block_row = np.zeros((self.max_pages_per_seq,), np.int32)
        block_row[:len(req.pf_pages)] = req.pf_pages
        dp.activate_slot(self.state, req.slot, block_row, n, first[0])
        self._bind_slot(req, req.slot, n)
        if self.enable_prefix_cache:
            n_shared = len(self._slot_shared.get(req.slot, ()))
            self._register_blocks(req.slot, tokens, req.pf_hashes, n_shared,
                                  self._slot_pages[req.slot])
        first_id = int(first[0])
        self.prefill_seconds += time.perf_counter() - t0
        self._first_token(req, first_id)

    # ------------------------------------------------------------ speculative

    def _index_ngram_at(self, req: _Request, end: int):
        """Record the n-gram ending at history position end-1; its
        continuation starts at `end`."""
        n = self.ngram_size
        if end < n:
            return
        key = tuple(req.history[end - n:end])
        latest, _prev = req.ngram_index.get(key, (None, None))
        req.ngram_index[key] = (end, latest)

    def _propose_drafts(self, req: _Request) -> list:
        """Prompt-lookup drafts: the continuation after the most recent
        earlier occurrence of the trailing n-gram in the request's own
        history; no match → repeat the last token."""
        k = self.speculative_k
        h = req.history
        n = self.ngram_size
        if req.ngram_index is None:  # first proposal: index the prompt
            req.ngram_index = {}
            for end in range(n, len(h) + 1):
                self._index_ngram_at(req, end)
        if len(h) > n:
            latest, prev = req.ngram_index.get(tuple(h[-n:]), (None, None))
            # `latest` is the trailing occurrence itself; the draft source
            # is the one before it
            cs = prev if latest == len(h) else latest
            if cs is not None:
                cont = h[cs:cs + k]
                if cont:
                    return (cont + [h[-1]] * (k - len(cont)))[:k]
        return [h[-1] if h else 0] * k

    def _speculative_step(self):
        """One multi-token decode: verify n-gram drafts for every active
        row, emit the accepted prefix plus one corrected token."""
        if self._spans is not None:
            self._phase("decode_launch")
        t_step = time.perf_counter()
        c_step = time.thread_time()
        K = self.speculative_k + 1
        S = self.max_slots
        draft = np.zeros((S, self.speculative_k), np.int32)
        for slot, req in self._by_slot.items():
            draft[slot] = self._propose_drafts(req)
        self.state, logits = decoding.verify_step(
            self.params, self.state, draft, self.cfg, K)
        toks = self._agree(decoding.sample_per_row(
            logits.reshape(S * K, logits.shape[-1]), self._gen,
            self._temps.repeat_interleave(K), self._topks.repeat_interleave(K)))
        toks_host = self._host_ids(toks, t_step, c_step)[0].reshape(S, K)
        now = time.time()
        counts = np.zeros((S,), np.int32)
        last = np.zeros((S,), np.int32)
        self.spec_steps += 1
        self.spec_slot_steps += len(self._by_slot)
        for slot, req in list(self._by_slot.items()):
            a = 0
            while (a < self.speculative_k
                   and toks_host[slot, a] == draft[slot, a]):
                a += 1
            self.spec_drafted += self.speculative_k
            self.spec_accepted += a
            req.accepted += a
            counts[slot] = a + 1
            last[slot] = toks_host[slot, a]
            for j in range(a + 1):
                self._emit(req, int(toks_host[slot, j]), now)
                if slot not in self._by_slot:
                    break  # finished (EOS/max_tokens) mid-burst
        # released rows (inside _emit) are inactive: commit skips them
        decoding.commit_accepted(self.state, last, counts)

    # ------------------------------------------------------------ emit/release

    def _emit(self, req: _Request, token_id: int, now: float):
        """Put one token on the request's stream; `now` is the pass's stamp
        of when it was sampled."""
        if self._phase_gap is not None:
            last = req.last_emit_ts or req.admitted_ts
            if last:
                self._phase_gap.observe(now - last)
            req.last_emit_ts = now
        req.generated += 1
        req.history.append(token_id)
        if self.speculative_k and req.ngram_index is not None:
            self._index_ngram_at(req, len(req.history))
        fsm = self._guided_fsm.get(req.slot)
        if fsm is not None:
            self._guided_state[req.slot] = fsm.step(
                self._guided_state[req.slot], token_id)
        eos = token_id in req.params.stop_token_ids
        if not eos:
            req.out_queue.put(token_id)
        if eos or req.generated >= req.params.max_tokens:
            self._release_active(req)
            req.out_queue.put(_SENTINEL)

    def _release_active(self, req: _Request) -> None:
        """Return an active row's slot, pages, LoRA ref and guided-FSM
        state to their pools: the one release path of normal completion
        (_emit) and mid-stream abort (_abort_one)."""
        decoding.release_slot(self.state, req.slot)
        if self.kv_layout == "paged":
            self._free_pages.extend(self._slot_pages.pop(req.slot, ()))
            if self.enable_prefix_cache:
                self._release_shared(req.slot)
        if self.lora_bank is not None:
            self._slot_lora[req.slot] = 0
        self._lora_release(req)
        self._guided_fsm.pop(req.slot, None)
        self._guided_state.pop(req.slot, None)
        self._free.append(req.slot)
        del self._by_slot[req.slot]

    # -------------------------------------------------- cancellation plane

    def _count_cancel(self) -> None:
        self.aborts += 1
        try:
            from ray_tpu_torch.serve import request_context as _rc

            _rc.count_cancellation("engine")
        except Exception as e:  # metrics must never kill the scheduler
            # (every in-flight request would die)
            logger.debug("cancellation metric failed: %r", e)

    def _abort_one(self, req: _Request, err: BaseException) -> bool:
        """Reclaim one request wherever it lives (active slot, staged
        chunked prefill, page-pressure backlog) and surface `err` to its
        caller. False when it is in none of them."""
        if req.slot >= 0 and self._by_slot.get(req.slot) is req:
            self._release_active(req)
        elif req in self._streaming:
            # _fail_stream reclaims and puts its own _RequestError; counted
            # first, so a caller that sees the error reads the count too
            self._count_cancel()
            self._fail_stream(req, err)
            return True
        elif req in self._prefilling:
            self._prefilling.remove(req)
            self._free_pages.extend(self._slot_pages.pop(req.slot, ()))
            self._release_shared(req.slot)
            self._free.append(req.slot)
            self._lora_release(req)
        elif req in self._backlog:
            self._backlog.remove(req)
            self._lora_release(req)
        else:
            return False
        self._count_cancel()
        req.out_queue.put(_RequestError(err))
        return True

    def _apply_aborts(self, now: float) -> None:
        with self._count_lock:
            agreed = self._abort_log[:self._agreed_aborts]
            del self._abort_log[:self._agreed_aborts]
        self._agreed_aborts = 0
        for rid in agreed:
            self._abort_pending.setdefault(rid, now)
        if not self._abort_pending:
            return
        for req in (list(self._by_slot.values()) + list(self._streaming)
                    + list(self._prefilling) + list(self._backlog)):
            if req.rid in self._abort_pending and self._abort_one(
                    req, RequestCancelledError(f"request {req.rid} cancelled")):
                del self._abort_pending[req.rid]
        for rid, t in list(self._abort_pending.items()):
            if now - t > 120.0:
                del self._abort_pending[rid]

    def _expire_deadlines(self, now: float) -> None:
        for reqs in (self._by_slot.values(), self._streaming,
                     self._prefilling, self._backlog):
            for req in list(reqs):
                if req.deadline_ts and now > req.deadline_ts:
                    self._abort_one(req, DeadlineExceededError(
                        f"request {req.rid} deadline exceeded "
                        f"({now - req.deadline_ts:.3f}s past)"))
                    self._abort_pending.pop(req.rid, None)

    def _cancel_at_admission(self, req: _Request) -> bool:
        if self._abort_pending.pop(req.rid, None) is not None:
            err: BaseException = RequestCancelledError(
                f"request {req.rid} cancelled before admission")
        elif req.deadline_ts and self._now > req.deadline_ts:
            err = DeadlineExceededError(
                f"request {req.rid} deadline expired during queue wait")
        else:
            return False
        self._lora_release(req)
        self._count_cancel()
        req.out_queue.put(_RequestError(err))
        return True

    # ------------------------------------------------------------------ loop

    def _loop(self):
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            self._loop_inner()
        except BaseException as e:  # noqa: BLE001 — engine death must unblock callers
            self._error = e
            self._drain_all(e)
            raise
        finally:
            try:
                self._profile_close()
            except Exception as e:  # noqa: BLE001 — the loop's own exit
                # (or error) is what the callers see
                logger.warning("stopping the engine's profile failed: %r", e)

    def _pages_bound(self) -> int:
        """Power-of-two bound on the batch's live page span (host mirror of
        the device lengths): the ragged decode step sweeps only this many
        block-table columns."""
        P = self.page_size
        need = 1
        for req in self._by_slot.values():
            pos = req.length0 + max(0, req.generated - 1)
            need = max(need, pos // P + 1)
        return min(_pow2_at_least(need), self.max_pages_per_seq)

    def _decode_step(self):
        if self.kv_layout == "paged":
            if self.attn_impl == "ragged":
                return dp.decode_step_paged_ragged(
                    self.params, self.state, self.cfg, self._pages_bound())
            return dp.decode_step_paged(self.params, self.state, self.cfg)
        return decoding.decode_step(self.params, self.state, self.cfg,
                                    self.lora_bank,
                                    None if self.lora_bank is None
                                    else self._slot_lora)

    def _guided_bias(self, shape) -> torch.Tensor:
        """Per-slot FSM masks as an additive bias; `remaining` turns on the
        budget-aware closing mask, so an unbounded pattern completes before
        max_tokens."""
        bias = np.zeros(shape, np.float32)
        for slot, fsm in self._guided_fsm.items():
            r = self._by_slot[slot]
            bias[slot] = _guided.bias_row(
                fsm, self._guided_state[slot],
                remaining=r.params.max_tokens - r.generated)
        return torch.as_tensor(bias, device=self.device)

    def _sync_pass(self) -> bool:
        """The pass's agreed requests, aborts, clock and stop: the engine's
        own, and under a mesh one allreduce over tp makes every rank agree
        on the requests and aborts all ranks have received (the minimum
        counts), on the clock (the earliest) and on stopping (if any rank
        stops). False when the engine stops."""
        with self._count_lock:
            got = [-float(self._submitted), -float(len(self._abort_log)),
                   float(self._stop), -time.time()]
        if self.mesh is not None:
            got = collectives.allreduce_max(
                torch.tensor(got, dtype=torch.float64, device=self.device),
                MESH_AXIS_TP).tolist()
        self._agreed_submitted = int(-got[0])
        self._agreed_aborts = int(-got[1])
        self._now = -got[3]
        return got[2] == 0.0

    def _idle(self) -> bool:
        return (not self._by_slot and self._waiting.empty()
                and not self._backlog and not self._prefilling
                and not self._streaming)

    def _loop_inner(self):
        with use_mesh(self.mesh):
            while self._pass():
                pass

    def _pass(self) -> bool:
        """One scheduler pass; False when the engine stops. With the
        device-trace hook on, each phase boundary stamps a span
        (``_phase``); off, it costs one ``is None`` test."""
        if self._prof_req is not None:
            self._profile_command()
        if self._spans is not None and (time.time_ns() - self._prof_t0
                                        > PROFILE_SLICE_MAX_S * 1e9):
            self._profile_stop()
        if self._idle():  # local state: it only paces the pass
            if self._spans is not None:
                self._phase("wait")
            self._work.wait(timeout=0.1)
            self._work.clear()
        if self._spans is not None:
            self._phase("sched")
        if not self._sync_pass():
            return False
        # aborted and expired rows are back in the pool before this pass
        # admits or steps anything
        self._apply_aborts(self._now)
        self._expire_deadlines(self._now)
        self._admit()
        if self._streaming:
            if self._spans is not None:
                self._phase("admit")
            streamed = self._drain_streams()
        else:
            streamed = False
        if self._prefilling:
            # one chunk a pass: running requests keep emitting while a long
            # prompt streams in
            if self._spans is not None:
                self._phase("prefill")
            self._prefill_step()
        if not self._by_slot:
            if self._streaming and not streamed:
                # nothing to decode and no new pages: park until the
                # transfer plane's feed() wakes the loop
                if self._spans is not None:
                    self._phase("wait")
                self._work.wait(timeout=0.005)
                self._work.clear()
            return True
        if self.speculative_k:
            self._speculative_step()
            return True
        if self._spans is not None:
            self._phase("decode_launch")
        t_step = time.perf_counter()
        c_step = time.thread_time()
        self.state, logits = self._decode_step()
        if self._guided_fsm:
            logits = logits + self._guided_bias(logits.shape)
        toks = self._agree(decoding.sample_per_row(
            logits, self._gen, self._temps, self._topks))
        decoding.commit_tokens(self.state, toks)
        toks_host, step_s = self._host_ids(toks, t_step, c_step)
        now = time.time()
        self.decode_steps += 1
        self.decode_slot_steps += len(self._by_slot)
        if self._step_obs is not None:
            # device step + sampling sync, by attention impl
            self._step_obs.observe(step_s)
        for slot, req in list(self._by_slot.items()):
            self._emit(req, int(toks_host[slot]), now)
        return True

    def _host_ids(self, toks, t_step: float, c_step: float):
        """The step's sampled ids on the host, and its wall seconds from
        `t_step` (perf_counter; `c_step` the thread_time then): the launch
        ends where the copy starts, the sync is the wait in the copy."""
        c_launch = time.thread_time()
        t_launch = time.perf_counter()
        self.decode_launch_cpu_seconds += c_launch - c_step
        self.decode_launch_seconds += t_launch - t_step
        if self._spans is not None:
            self._phase("decode_sync")
        ids = toks.cpu().numpy()
        t_end = time.perf_counter()
        if self._spans is not None:
            self._phase("emit")
        self.decode_sync_seconds += t_end - t_launch
        self.decode_seconds += t_end - t_step
        return ids, t_end - t_step

    # ------------------------------------------------------- device trace

    def start_profile(self) -> float:
        """Start the device-trace hook: ``torch.profiler`` records the
        CUDA kernels (the CPU ops where the engine runs on the CPU), started
        on the scheduler's thread, which stamps each of its phases until
        ``stop_profile``, or for ``PROFILE_SLICE_MAX_S`` at most: ``sched``
        (the pass's agreement, aborts, deadlines), ``admit``, ``prefill``
        (a prompt's forward, or one chunk of it, and its first token's
        sync), ``decode_launch``, ``decode_sync``, ``emit`` and ``wait``
        (parked for work). Returns the start, ``time.time()`` seconds."""
        return self._profile_call("start") / 1e9

    def stop_profile(self) -> dict:
        """End the trace and reduce it (``util/device_trace.reduce``): the
        slice's length, the device's busy seconds (the union of kernel
        intervals) and idle seconds, the idle put down to the scheduler's
        phase that was open (``idle_s_by_phase``, ``outside`` where none
        was), each phase's host seconds and the heaviest kernels; with the
        spans kept and dropped (``PROFILE_SPANS_MAX``), whether the slice
        ran into ``PROFILE_SLICE_MAX_S`` (``capped``) and the seconds the
        scheduler spent, outside the slice, starting the profiler, stopping
        it and reducing its trace (all on its own thread, so that these
        three are the hook's whole stall). With no profile on, returns the
        last slice's result again (one the cap ended, or one whose caller
        gave up waiting); raises if no slice ran since the last start."""
        return self._profile_call("stop")

    def _profile_call(self, what: str):
        """Hand a start or stop to the scheduler's thread, which runs it
        at the top of its next pass, and wait for its result."""
        with self._prof_lock:
            self._check_alive()
            done, box = threading.Event(), {}
            with self._prof_hand:
                self._prof_req = (what, done, box)
            self._work.set()
            if not done.wait(PROFILE_CALL_TIMEOUT_S):
                with self._prof_hand:
                    # withdrawn, unless the scheduler has taken it: a stop
                    # it runs then keeps its result for the next stop
                    self._prof_req = None
                raise TimeoutError(f"the engine's scheduler took no profile "
                                   f"{what} within {PROFILE_CALL_TIMEOUT_S} s")
        if "error" in box:
            raise box["error"]
        return box["value"]

    def _profile_command(self) -> None:
        with self._prof_hand:
            req, self._prof_req = self._prof_req, None
        if req is None:
            return  # its caller timed out and withdrew it
        what, done, box = req
        try:
            if what == "start":
                box["value"] = self._profile_start()
            elif self._prof is not None:
                box["value"] = self._profile_stop()
            elif self._prof_result is not None:
                box["value"] = self._prof_result
            else:
                raise RuntimeError("no profile is on")
        except Exception as e:  # noqa: BLE001 — the caller's error, not the
            # scheduler's (a second profiler, say)
            box["error"] = e
        finally:
            done.set()

    def _profile_start(self) -> int:
        if self._prof is not None:
            raise RuntimeError("a profile is already on")
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                   else ProfilerActivity.CPU])
        if cuda:
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        prof.start()
        self._prof_start_s = time.perf_counter() - t
        self._prof, self._prof_t0 = prof, time.time_ns()
        self._spans, self._span_open = [], None
        self._spans_dropped = 0
        self._prof_result = None
        return self._prof_t0

    def _profile_stop(self) -> dict:
        """End the running slice now; its result, also kept in
        ``_prof_result``."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t1 = time.time_ns()
        spans, was = self._spans, self._span_open
        if was is not None:
            spans.append((was[0], was[1], t1))
        prof = self._profile_close()
        t2 = time.time_ns()
        out = device_trace.reduce(device_trace.kernel_events(prof, cuda),
                                  self._prof_t0, t1, spans)
        del out["kernel_s"]
        out.update(start=self._prof_t0 / 1e9, spans=len(spans),
                   spans_dropped=self._spans_dropped,
                   capped=t1 - self._prof_t0 > PROFILE_SLICE_MAX_S * 1e9,
                   profiler_start_s=self._prof_start_s,
                   profiler_stop_s=(t2 - t1) / 1e9,
                   reduce_s=(time.time_ns() - t2) / 1e9)
        self._prof_result = out
        return out

    def _profile_close(self):
        """Stop the profiler, if one runs, and the spans; returns it."""
        prof, self._prof, self._spans = self._prof, None, None
        if prof is not None:
            prof.stop()
        return prof

    def _phase(self, name: str) -> None:
        """The scheduler enters phase `name` (the hook is on): the open
        span closes now; past ``PROFILE_SPANS_MAX`` spans are counted, not
        kept."""
        was = self._span_open
        if was is not None and was[0] == name:
            return
        now = time.time_ns()
        self._span_open = (name, now)
        if was is not None:
            if len(self._spans) < PROFILE_SPANS_MAX:
                self._spans.append((was[0], was[1], now))
            else:
                self._spans_dropped += 1

    # ---------------------------------------------------------------- stats

    def stats(self) -> dict:
        out = {"free_slots": len(self._free), "active": len(self._by_slot),
               "waiting": self._waiting.qsize() + len(self._backlog),
               "streaming": len(self._streaming),
               "max_slots": self.max_slots, "buckets": list(self.buckets),
               "kv_layout": self.kv_layout, "attn_impl": self.attn_impl,
               "ragged_kernel": self._ragged_kernel,
               "device": str(self.device),
               "decode_steps": self.decode_steps,
               "decode_slot_steps": self.decode_slot_steps,
               "prefills": self.prefills,
               "prefix_prefills": self.prefix_prefills,
               "prefill_seconds": self.prefill_seconds,
               "decode_seconds": self.decode_seconds,
               "decode_launch_seconds": self.decode_launch_seconds,
               "decode_sync_seconds": self.decode_sync_seconds,
               "decode_launch_cpu_seconds": self.decode_launch_cpu_seconds,
               "aborts": self.aborts,
               "decode_occupancy": (self.decode_slot_steps / self.decode_steps
                                    if self.decode_steps else 0.0)}
        if self.speculative_k:
            drafted = self.spec_drafted
            out["speculative"] = {
                "k": self.speculative_k, "steps": self.spec_steps,
                "drafted": drafted, "accepted": self.spec_accepted,
                "acceptance_rate": (self.spec_accepted / drafted
                                    if drafted else 0.0),
                # per-sequence advance per verify step
                "tokens_per_step": ((self.spec_accepted
                                     + self.spec_slot_steps)
                                    / self.spec_slot_steps
                                    if self.spec_slot_steps else 0.0),
            }
        if self.kv_layout == "paged":
            out["free_pages"] = len(self._free_pages)
            out["num_pages"] = self.num_pages
            out["page_size"] = self.page_size
            if self.prefill_chunk:
                out["prefill_chunk"] = self.prefill_chunk
                out["prefill_chunks_run"] = self.prefill_chunks_run
                out["prefilling"] = len(self._prefilling)
            if self.enable_prefix_cache:
                hits, misses = self.prefix_hits, self.prefix_misses
                out["prefix_cache"] = {
                    "hits": hits, "misses": misses,
                    "hit_rate": hits / (hits + misses) if hits + misses else 0.0,
                    "tokens_reused": self.prefix_tokens_reused,
                    "cached_blocks": len(self._prefix_cache),
                    "reclaimable_pages": self._reclaimable_pages(),
                }
        return out
