"""LLMServer deployment + OpenAI-compatible ingress, over LLMEngine.

The port's copy of ray_tpu/llm/server.py: the same deployment, wire shapes
(completions, chat, their SSE streams, /v1/stats), guided decoding, LoRA
adapters through `multiplexed`, and the replica's deadline and cancel hooks;
besides, with ``LLMConfig(profile_routes=True)``, POST /start_profile and
/stop_profile (vLLM's operator routes) bracket a device trace of the
engine whose idle is put down to its phases.
The engine runs on the replica's GPU unless
``engine_kwargs={"device": "cpu"}``; a replica gets its GPU through
``deployment_config={"ray_actor_options": {"num_gpus": 1}}``.

(reference: llm/_internal/serve/core/server/llm_server.py:97 LLMServer wraps
the engine as a Serve deployment; core/ingress/ provides the OpenAI-style
/v1/completions + /v1/chat/completions routes; build_openai_app composes
them.)
"""

from __future__ import annotations

import os
import time

from ray_tpu_torch import serve
from ray_tpu_torch.serve import replica as _replica
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.llm.engine import SamplingParams, LLMEngine
from ray_tpu_torch.llm.tokenizer import load_tokenizer


class _AdapterHandle:
    """The multiplex cache entry for a loaded adapter: eviction from the
    LRU calls __del__, which frees the engine's bank slot (unless requests
    are mid-flight — then the slot frees on the next load's eviction pass).
    ensure() re-loads the adapter if the engine-side eviction pass freed
    its bank slot while this cache entry stayed live."""

    def __init__(self, engine: LLMEngine, loading_path: str,
                 adapter_id: str):
        self.engine = engine
        self.loading_path = loading_path
        self.adapter_id = adapter_id
        self._evicted = False

    def ensure(self) -> None:
        if self.adapter_id not in self.engine.list_loras():
            _load_weights(self.engine, self.loading_path, self.adapter_id)

    def __del__(self):
        # multiplex eviction calls __del__ explicitly AND the interpreter
        # calls it again at GC time — without the guard the second call
        # could unload an adapter that was RELOADED after eviction
        if self._evicted:
            return
        self._evicted = True
        try:
            self.engine.unload_lora(self.adapter_id)
        except Exception:
            pass  # in use or already gone: next load's eviction retries


def _load_weights(engine: LLMEngine, loading_path: str,
                  adapter_id: str) -> None:
    """Read <loading_path>/<adapter_id>.npz (A_q/B_q/A_v/B_v layer-stacked,
    optional scalar alpha) into the engine bank, evicting an idle adapter
    if the bank is full (reference: lora_serve_utils.py downloads adapter
    weights by model id and hands them to the engine)."""
    import numpy as np

    path = os.path.join(loading_path, f"{adapter_id}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no adapter {adapter_id!r} under {loading_path!r}")
    z = np.load(path)
    weights = {k: z[k] for k in ("A_q", "B_q", "A_v", "B_v") if k in z.files}
    alpha = float(z["alpha"]) if "alpha" in z.files else None
    try:
        engine.load_lora(adapter_id, weights, alpha=alpha)
    except ValueError as e:
        if "already loaded" in str(e):
            return  # a concurrent ensure() won the race: done
        raise
    except RuntimeError:
        # bank full: evict an idle adapter (multiplex eviction may have
        # been unable to free it while requests were live)
        for name in engine.list_loras():
            try:
                engine.unload_lora(name)
                break
            except RuntimeError:
                continue  # live requests: try the next one
            except KeyError:
                # a concurrent thread unloaded it between list and unload —
                # that freed a slot, which is all this loop is after
                break
        try:
            engine.load_lora(adapter_id, weights, alpha=alpha)
        except ValueError as e:
            if "already loaded" not in str(e):
                raise


def _load_adapter_into_engine(engine: LLMEngine, loading_path: str,
                              adapter_id: str) -> _AdapterHandle:
    if adapter_id not in engine.list_loras():
        _load_weights(engine, loading_path, adapter_id)
    return _AdapterHandle(engine, loading_path, adapter_id)


@serve.deployment(max_ongoing_requests=16)
class LLMServer:
    """One engine per replica; requests ride replica threads and park on the
    engine's continuous-batching queue."""

    def __init__(self, llm_config: LLMConfig):
        self.config = llm_config
        self.engine = LLMEngine.from_config(llm_config)
        self.tokenizer = load_tokenizer(llm_config.model_loading_config.tokenizer)
        self._get_adapter = None
        lc = getattr(llm_config, "lora_config", None)
        if lc is not None:
            from ray_tpu_torch.serve.multiplex import multiplexed

            engine, path = self.engine, lc.dynamic_lora_loading_path

            @multiplexed(
                max_num_models_per_replica=lc.max_num_adapters_per_replica)
            def _get(adapter_id: str):
                return _load_adapter_into_engine(engine, path, adapter_id)

            self._get_adapter = _get

    def _maybe_lora(self, body: dict) -> str | None:
        """A request whose `model` names something other than the base
        model is a LoRA adapter request (reference: serve LLM treats
        model_id as the multiplexed adapter id — lora_serve_utils.py)."""
        model = body.get("model")
        if (self._get_adapter is None or not model
                or model == self.config.model_loading_config.model_id):
            return None
        handle = self._get_adapter(model)  # load or LRU-refresh (mux cache)
        handle.ensure()  # heal a cache hit whose bank slot was evicted
        return model

    def _params(self, body: dict) -> SamplingParams:
        eos = getattr(self.tokenizer, "eos_token_id", None)
        guided = None
        choices = body.get("guided_choice")
        if choices:
            # structured output, choice flavor (reference: guided_decoding
            # params passed through the OpenAI surface to the engine —
            # vllm_engine_stage.py:278): output must be exactly one of the
            # given strings, enforced token-by-token in the decode step
            from ray_tpu_torch.llm.guided import GuidedFSM

            if eos is None:
                raise ValueError(
                    "guided_choice requires a tokenizer with an EOS token")
            encoded = [self._encode_continuation(c) for c in choices]
            guided = GuidedFSM.from_choices(
                encoded, self.engine.cfg.vocab_size, eos)
            # the guided contract is "exactly one of the choices": never
            # let max_tokens cut the FSM off mid-choice
            body = {**body, "max_tokens": max(
                int(body.get("max_tokens", 64)),
                max(len(e) for e in encoded) + 1)}
        elif body.get("guided_regex"):
            # regex flavor: exact for byte-level tokenizers, where one
            # token is one character (reference: guided_decoding regex)
            from ray_tpu_torch.llm.guided import GuidedFSM

            if eos is None:
                raise ValueError(
                    "guided_regex requires a tokenizer with an EOS token")
            if not getattr(self.tokenizer, "byte_level", False):
                raise ValueError(
                    "guided_regex needs a byte-level tokenizer (one token "
                    "per character); use guided_choice for subword models")
            if len(body["guided_regex"]) > 1024:
                raise ValueError("guided_regex longer than 1024 chars")
            guided = GuidedFSM.from_regex(
                body["guided_regex"], self.engine.cfg.vocab_size, eos)
            # a budget below the pattern's minimum length could only ever
            # return a truncated non-match: bump like guided_choice does
            min_len = int(guided.dist[guided.start])
            if min_len < 2 ** 31 - 1:
                body = {**body, "max_tokens": max(
                    int(body.get("max_tokens", 64)), min_len + 1)}
        return SamplingParams(
            max_tokens=int(body.get("max_tokens", 64)),
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            stop_token_ids=(eos,) if eos is not None else (),
            guided=guided,
        )

    def _encode_continuation(self, text: str) -> list:
        """Tokenize a guided choice as a CONTINUATION: BOS/special tokens
        would otherwise be baked into the FSM and forced into the output."""
        try:
            return self.tokenizer.encode(text, add_bos=False)
        except TypeError:
            pass
        try:
            return self.tokenizer.encode(text, add_special_tokens=False)
        except TypeError:
            return self.tokenizer.encode(text)

    def _submit_retry(self, ids: list, params, lora: str | None):
        """Submit with one evicted-adapter reload retry: multiplex churn can
        evict the adapter between ensure() and submit. One shared path for
        blocking and streaming completions; returns the engine request
        (iterable over generated tokens)."""
        deadline_ts = _replica.request_deadline() or 0.0
        try:
            req = self.engine.submit(ids, params, lora=lora,
                                     deadline_ts=deadline_ts)
        except KeyError:
            if lora is None:
                raise
            self._get_adapter(lora).ensure()
            req = self.engine.submit(ids, params, lora=lora,
                                     deadline_ts=deadline_ts)
        # a cancel observed by the serve plane (client disconnect, explicit
        # cancel(), timed-out caller) reclaims this request's decode slot
        # and KV pages in one step instead of decoding to max_tokens
        _replica.on_cancel(lambda: self.engine.abort_request(req.rid))
        return req

    def completions(self, body: dict) -> dict:
        prompt = body.get("prompt", "")
        t0 = time.monotonic()
        lora = self._maybe_lora(body)
        ids = self.tokenizer.encode(prompt)
        out_ids = list(self._submit_retry(ids, self._params(body), lora))
        dt = time.monotonic() - t0
        return {
            "object": "text_completion",
            "model": lora or self.config.model_loading_config.model_id,
            "choices": [{"index": 0, "text": self.tokenizer.decode(out_ids),
                         "finish_reason": "stop"}],
            "usage": {"prompt_tokens": len(ids),
                      "completion_tokens": len(out_ids),
                      "total_time_s": round(dt, 4)},
        }

    def chat(self, body: dict) -> dict:
        msgs = body.get("messages", [])
        prompt = "".join(f"<{m.get('role', 'user')}>{m.get('content', '')}\n"
                         for m in msgs) + "<assistant>"
        out = self.completions({**body, "prompt": prompt})
        out["object"] = "chat.completion"
        out["choices"] = [{"index": 0, "finish_reason": "stop",
                           "message": {"role": "assistant",
                                       "content": out["choices"][0]["text"]}}]
        return out

    def engine_stats(self) -> dict:
        return self.engine.stats()

    def start_profile(self) -> dict:
        """Start the engine's device-trace hook (``LLMEngine.start_profile``;
        the ``/start_profile`` route, as vLLM's)."""
        return {"start": self.engine.start_profile()}

    def stop_profile(self) -> dict:
        """End it: the slice's device busy and idle seconds, the idle by
        the engine phase that was open, the heaviest kernels
        (``LLMEngine.stop_profile``; the ``/stop_profile`` route)."""
        return self.engine.stop_profile()

    def completions_stream(self, body: dict):
        """Token-by-token SSE chunks, OpenAI text_completion.chunk shape
        (reference: llm serve streams engine tokens through the replica —
        llm_server.py + proxy streaming)."""
        prompt = body.get("prompt", "")
        lora = self._maybe_lora(body)
        model = lora or self.config.model_loading_config.model_id
        ids = self.tokenizer.encode(prompt)
        req = self._submit_retry(ids, self._params(body), lora)
        for tok in req:
            yield {
                "object": "text_completion.chunk",
                "model": model,
                "choices": [{"index": 0, "text": self.tokenizer.decode([tok]),
                             "finish_reason": None}],
            }
        yield {"object": "text_completion.chunk", "model": model,
               "choices": [{"index": 0, "text": "", "finish_reason": "stop"}]}

    def chat_stream(self, body: dict):
        msgs = body.get("messages", [])
        prompt = "".join(f"<{m.get('role', 'user')}>{m.get('content', '')}\n"
                         for m in msgs) + "<assistant>"
        for chunk in self.completions_stream({**body, "prompt": prompt}):
            text = chunk["choices"][0].pop("text")
            chunk["object"] = "chat.completion.chunk"
            chunk["choices"][0]["delta"] = {"content": text}
            yield chunk

    def stream_request(self, request: dict):
        """Streaming HTTP entry (SSE through the proxy)."""
        path = request.get("path", "")
        body = request.get("body") or {}
        if path.endswith("/chat/completions"):
            yield from self.chat_stream(body)
        else:
            yield from self.completions_stream(body)

    def __call__(self, request: dict) -> dict:
        """HTTP entry: route by path suffix (OpenAI wire shapes)."""
        path = request.get("path", "")
        body = request.get("body") or {}
        if path.endswith("/chat/completions"):
            return self.chat(body)
        if path.endswith("/stats"):
            # engine observability: slots/pages plus the prefix-cache and
            # speculative sections when those features are enabled
            return self.engine_stats()
        if path.endswith(("/start_profile", "/stop_profile")):
            return self._profile_route(path, request.get("method"))
        return self.completions(body)

    def _profile_route(self, path: str, method: str | None) -> dict:
        if not self.config.profile_routes:
            raise PermissionError(f"{path}: the profile routes are off "
                                  "(LLMConfig(profile_routes=True))")
        if method != "POST":
            raise ValueError(f"{path} takes POST, not {method}")
        if path.endswith("/start_profile"):
            return self.start_profile()
        return self.stop_profile()


def build_openai_app(llm_config: LLMConfig) -> serve.Application:
    """(reference: llm serve builds an ingress app from LLMConfig —
    serve/core/ingress; deployment options come from deployment_config.)"""
    dep = LLMServer
    opts = dict(llm_config.deployment_config)
    # LLM serving defaults to prefix-aware routing: requests sharing a prompt
    # prefix hit the same replica for KV reuse (reference: llm request_router/
    # prefix_aware/prefix_tree.py)
    opts.setdefault("request_router", "prefix_aware")
    dep = dep.options(**opts)
    return dep.bind(llm_config)
