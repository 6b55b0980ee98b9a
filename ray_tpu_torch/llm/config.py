"""LLMConfig — the config object the engine is built from (own copy of
ray_tpu/llm/config.py's LLMConfig, ModelLoadingConfig, LoraConfig and
PDConfig, without jax).

``build_model`` builds a config of the gpt2, llama or mixtral family
(the JAX package's factory table) and returns random weights
drawn on the device when ``model_source`` is None, as the JAX package
does, and loads an npz checkpoint otherwise. Serving stores the weights
once in ``cfg.dtype``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ModelLoadingConfig:
    model_id: str = "tiny"  # a size key of the chosen model family
    # npz checkpoint path or None → random init of the model config
    model_source: str | None = None
    tokenizer: str | None = "byte"


@dataclass
class LoraConfig:
    """Multi-LoRA serving: ``LLMEngine.from_config`` sizes its adapter bank
    from it (max_loras, lora_rank). The serve layer, which loads adapters
    from ``dynamic_lora_loading_path``, is not ported yet."""

    dynamic_lora_loading_path: str = ""  # dir of <adapter_id>.npz files
    max_num_adapters_per_replica: int = 4
    lora_rank: int = 8


@dataclass
class PDConfig:
    """Prefill/decode disaggregation knobs (llm/pd.py, llm/kv_transfer.py);
    every field and default of the JAX package's PDConfig."""

    # KV handoff granularity in tokens; must divide the engine buckets, so
    # both pools bump min_bucket up to it (pd._pd_engine_kwargs). Power of 2.
    page_size: int = 64
    # handoff timeout: a decode side that never pulls (or dies mid-pull)
    # frees the prefill side's channel after this long
    transfer_timeout_s: float = 60.0
    # pages per transfer message: the in-flight prefetch window, at the
    # cost of prefetch_depth * page_bytes of channel buffer per transfer
    prefetch_depth: int = 2
    # decode-side pulls through one shared BatchedKVPuller + streamed slot
    # admission; False: pull everything, then admit
    batched_pull: bool = True
    # prefill-tier admission batching (pd.PrefillCoalescer): concurrent
    # same-bucket prompts coalesce into one [B, T] forward; the window is
    # how long the batch leader waits for stragglers
    prefill_batch_max: int = 4
    prefill_batch_window_s: float = 0.0015
    num_prefill_replicas: int = 1
    num_decode_replicas: int = 1


@dataclass
class LLMConfig:
    model_loading_config: ModelLoadingConfig = field(default_factory=ModelLoadingConfig)
    # the family of the built-in configs: gpt2, llama or mixtral
    model_family: str = "llama"
    model_kwargs: dict = field(default_factory=dict)
    # max_slots, max_len, min_bucket, seed, kv_layout, page_size, ...;
    # device ("cuda" by default, "cpu" on request)
    engine_kwargs: dict = field(default_factory=dict)
    deployment_config: dict = field(default_factory=dict)
    accelerator_type: str | None = "GPU"
    lora_config: LoraConfig | None = None
    # PD disaggregation; None → PDConfig() defaults
    pd_config: PDConfig | None = None

    def build_model(self, device=None):
        """Returns (TransformerConfig, params) on `device` (cuda unless the
        caller asks for the CPU)."""
        import torch

        from ray_tpu_torch import models
        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch.models import convert, transformer

        factory = {"gpt2": models.gpt2_config, "llama": models.llama_config,
                   "mixtral": models.mixtral_config}.get(self.model_family)
        if factory is None:
            raise ValueError("model_family must be 'gpt2', 'llama' or "
                             f"'mixtral', got {self.model_family!r}")
        device = resolve_device(device)
        cfg = factory(self.model_loading_config.model_id, **self.model_kwargs)
        src = self.model_loading_config.model_source
        if src:
            from ray_tpu_torch.llm import checkpoint_io

            params = convert.params_from_jax(checkpoint_io.load_params(src),
                                             cfg, device, cfg.dtype)
        else:
            seed = self.engine_kwargs.get("seed", 0)
            gen = torch.Generator(device=device).manual_seed(seed)
            params = transformer.init(gen, cfg, device, dtype=cfg.dtype)
        return cfg, params
