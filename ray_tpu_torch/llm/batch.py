"""Batch LLM inference as a data-pipeline stage (own copy of
ray_tpu/llm/batch.py, on the port's engine and Data).

(reference: llm/_internal/batch/processor/ — build_llm_processor composes
preprocess → engine → postprocess stages over Ray Data
(vllm_engine_proc.py); stages in _internal/batch/stages/. Here the engine
stage is an actor pool of LLMEngine replicas consumed via map_batches.)

As in the JAX package, the engine actor asks the runtime for no GPU. On
the card it reaches the GPU the way the PD pools do: with
``RAY_TPU_TORCH_WORKER_PLATFORM=cuda`` set before ``init``, every worker
sees it. The engine resolves its device as every entry point does:
``cuda`` unless ``engine_kwargs={"device": "cpu"}`` asks for the CPU, and
with no card and no such kwarg the engine's build fails in the actor and
the actor's first call raises that error to the processor's caller. It
never computes quietly on the CPU.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.llm.engine import SamplingParams


@ray_tpu_torch.remote
class _EngineWorker:
    def __init__(self, llm_config_blob: bytes):
        from ray_tpu_torch._private import serialization as ser

        from ray_tpu_torch.llm.engine import LLMEngine
        from ray_tpu_torch.llm.tokenizer import load_tokenizer

        llm_config = ser.loads(llm_config_blob)
        self.tokenizer = load_tokenizer(llm_config.model_loading_config.tokenizer)
        # keep the engine's build error (no card and no device=, a bad
        # checkpoint) for each call to raise as itself; the JAX package's
        # runtime leaves calls on an actor whose constructor raised
        # waiting, the port's fails them with ActorDiedError (its cause)
        self.error = None
        try:
            self.engine = LLMEngine.from_config(llm_config)
        except Exception as e:  # noqa: BLE001 — raised by generate_batch
            self.error = e

    def generate_batch(self, prompts: list, sampling: dict) -> list:
        from ray_tpu_torch.llm.engine import _iter_request

        if self.error is not None:
            raise RuntimeError(f"the batch engine actor has no engine: "
                               f"{self.error}") from self.error
        sp = SamplingParams(**sampling)
        reqs = [self.engine.submit(self.tokenizer.encode(p), sp) for p in prompts]
        return [self.tokenizer.decode(list(_iter_request(r))) for r in reqs]


class Processor:
    """(reference: batch/processor/processor.py Processor — callable over a
    Dataset; __call__ returns the transformed dataset.)"""

    def __init__(self, llm_config: LLMConfig, *, preprocess: Callable | None = None,
                 postprocess: Callable | None = None, concurrency: int = 1,
                 batch_size: int = 16, sampling_params: dict | None = None,
                 input_column: str = "prompt", output_column: str = "generated"):
        from ray_tpu_torch._private import serialization as ser

        self.blob = ser.dumps(llm_config)
        self.preprocess = preprocess
        self.postprocess = postprocess
        self.concurrency = concurrency
        self.batch_size = batch_size
        self.sampling = sampling_params or {"max_tokens": 32, "temperature": 0.0}
        self.input_column = input_column
        self.output_column = output_column
        self._workers = None

    def _pool(self):
        if self._workers is None:
            self._workers = [_EngineWorker.remote(self.blob)
                             for _ in range(self.concurrency)]
        return self._workers

    def __call__(self, dataset):
        if self.preprocess is not None:
            dataset = dataset.map(self.preprocess)
        workers = self._pool()
        refs, metas = [], []
        for i, batch in enumerate(dataset.iter_batches(
                batch_size=self.batch_size, batch_format="numpy")):
            prompts = [str(p) for p in np.asarray(batch[self.input_column]).tolist()]
            w = workers[i % len(workers)]
            refs.append(w.generate_batch.remote(prompts, self.sampling))
            metas.append(batch)
        rows = []
        for ref, batch in zip(refs, metas):
            outs = ray_tpu_torch.get(ref)
            keys = list(batch.keys())
            for j, text in enumerate(outs):
                row = {k: np.asarray(batch[k])[j] for k in keys}
                row[self.output_column] = text
                rows.append(row)
        import ray_tpu_torch.data as rdata

        out = rdata.from_items(rows)
        if self.postprocess is not None:
            out = out.map(self.postprocess)
        return out

    def shutdown(self):
        for w in self._workers or []:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self._workers = None


def build_llm_processor(llm_config: LLMConfig, **kwargs) -> Processor:
    """(reference: batch/processor/__init__.py build_llm_processor.)"""
    return Processor(llm_config, **kwargs)
