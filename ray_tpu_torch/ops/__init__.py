from ray_tpu_torch import _device  # noqa: F401 — numerics settings first
from ray_tpu_torch.ops.activations import geglu, gelu, swiglu
from ray_tpu_torch.ops.attention import attention, reference_attention, repeat_kv
# the flash_attention *function* stays in its module: exporting it here
# would shadow the submodule ray_tpu_torch.ops.flash_attention
from ray_tpu_torch.ops.flash_attention import (
    FlashAttention, flash_attention_backward, flash_attention_forward,
    kernel_fits)
from ray_tpu_torch.ops.losses import (fused_head_cross_entropy,
                                      softmax_cross_entropy)
from ray_tpu_torch.ops.moe import RoutingInfo, moe_apply, topk_routing
from ray_tpu_torch.ops.norms import layer_norm, rms_norm
from ray_tpu_torch.ops.ragged_paged_attention import (
    ragged_decode_attention, ragged_decode_attention_reference)
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

__all__ = [
    "FlashAttention",
    "RoutingInfo",
    "apply_rope",
    "attention",
    "flash_attention_backward",
    "flash_attention_forward",
    "fused_head_cross_entropy",
    "geglu",
    "gelu",
    "kernel_fits",
    "layer_norm",
    "moe_apply",
    "ragged_decode_attention",
    "ragged_decode_attention_reference",
    "reference_attention",
    "repeat_kv",
    "rms_norm",
    "rope_frequencies",
    "softmax_cross_entropy",
    "swiglu",
    "topk_routing",
]
