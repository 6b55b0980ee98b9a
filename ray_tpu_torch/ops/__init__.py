from ray_tpu_torch.ops.activations import geglu, gelu, swiglu
from ray_tpu_torch.ops.attention import attention, reference_attention, repeat_kv
from ray_tpu_torch.ops.flash_attention import flash_attention_forward
from ray_tpu_torch.ops.norms import layer_norm, rms_norm
from ray_tpu_torch.ops.ragged_paged_attention import (
    ragged_decode_attention, ragged_decode_attention_reference)
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = [
    "apply_rope",
    "attention",
    "flash_attention_forward",
    "geglu",
    "gelu",
    "layer_norm",
    "ragged_decode_attention",
    "ragged_decode_attention_reference",
    "reference_attention",
    "repeat_kv",
    "rms_norm",
    "rope_frequencies",
    "swiglu",
]
