from ray_tpu_torch.models import convert, decoding, decoding_paged, transformer
from ray_tpu_torch.models.llama import llama_config
from ray_tpu_torch.models.transformer import TransformerConfig

__all__ = [
    "TransformerConfig",
    "convert",
    "decoding",
    "decoding_paged",
    "llama_config",
    "transformer",
]
