"""ray_tpu_torch.llm — LLM serving on the GPU (PyTorch/CUDA port of
ray_tpu.llm): the engine, the PD plane (kv_transfer) and its deployments
on Serve (pd), the OpenAI server on Serve (server) and the batch
processor over Data (batch)."""

from ray_tpu_torch import _device  # noqa: F401 — numerics settings first

from ray_tpu_torch.llm.batch import Processor, build_llm_processor
from ray_tpu_torch.llm.config import (LLMConfig, LoraConfig,
                                      ModelLoadingConfig, PDConfig)
from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
from ray_tpu_torch.llm.guided import GuidedFSM
from ray_tpu_torch.llm.kv_transfer import KVTransferError, PagedKVExporter
from ray_tpu_torch.llm.pd import build_pd_openai_app
from ray_tpu_torch.llm.server import LLMServer, build_openai_app
from ray_tpu_torch.llm.tokenizer import ByteTokenizer, load_tokenizer

__all__ = [
    "ByteTokenizer",
    "GuidedFSM",
    "KVTransferError",
    "LLMConfig",
    "LLMEngine",
    "LLMServer",
    "LoraConfig",
    "ModelLoadingConfig",
    "PDConfig",
    "PagedKVExporter",
    "Processor",
    "SamplingParams",
    "build_llm_processor",
    "build_openai_app",
    "build_pd_openai_app",
    "load_tokenizer",
]
