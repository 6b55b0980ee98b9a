from ray_tpu_torch import _device  # noqa: F401 — numerics settings first
from ray_tpu_torch.models import (convert, decoding, decoding_paged,
                                  transformer, vit)
from ray_tpu_torch.models.gpt2 import gpt2_config
from ray_tpu_torch.models.llama import llama_config
from ray_tpu_torch.models.mixtral import mixtral_config
from ray_tpu_torch.models.transformer import MoEConfig, TransformerConfig
from ray_tpu_torch.models.vit import ViTConfig, vit_config

__all__ = [
    "MoEConfig",
    "TransformerConfig",
    "ViTConfig",
    "convert",
    "decoding",
    "decoding_paged",
    "gpt2_config",
    "llama_config",
    "mixtral_config",
    "transformer",
    "vit",
    "vit_config",
]
