"""ray_tpu_torch.llm — the LLM engine on one GPU (PyTorch/CUDA port of
ray_tpu.llm's engine) and the PD plane below Serve (kv_transfer, pd); the
serve layer above them is not ported yet."""

from ray_tpu_torch.llm.config import (LLMConfig, LoraConfig,
                                      ModelLoadingConfig, PDConfig)
from ray_tpu_torch.llm.engine import LLMEngine, SamplingParams
from ray_tpu_torch.llm.guided import GuidedFSM
from ray_tpu_torch.llm.tokenizer import ByteTokenizer

__all__ = [
    "ByteTokenizer",
    "GuidedFSM",
    "LLMConfig",
    "LLMEngine",
    "LoraConfig",
    "ModelLoadingConfig",
    "PDConfig",
    "SamplingParams",
]
