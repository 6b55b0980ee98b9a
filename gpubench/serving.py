"""The served model as the port builds it, from a configuration file.

``port_model`` asks the port's own factory for the configuration and
checks that it states what the file states; ``BenchLLMConfig`` is the
port's ``LLMConfig`` whose model is that configuration with the
benchmark's weights (``gpubench/weights.py``, drawn in the replica from the
seed). ``bench_server`` subclasses the port's ``LLMServer`` with what a run
reads in the replica: the device, its memory peak, a device-trace slice.
The request path is the port's. Its tokenizer is ``IdTokenizer``: a
prompt is its token ids written out, and each streamed chunk's text is
the served id, so the client sees what was served.
"""

from __future__ import annotations

import dataclasses

from ray_tpu_torch.llm.config import LLMConfig, ModelLoadingConfig

from gpubench import weights


def port_model(torch, cfg: dict):
    """The port's TransformerConfig of a configuration file."""
    from ray_tpu_torch import models
    from ray_tpu_torch.models.transformer import MoEConfig

    port = cfg["port"]
    kw = {"dtype": getattr(torch, port["dtype"])}
    for key in ("n_layers", "max_seq_len", "vocab_size", "remat",
                "remat_policy"):
        if key in port:
            kw[key] = port[key]
    if "param_dtype" in port:
        kw["param_dtype"] = getattr(torch, port["param_dtype"])
    d = weights.dims(cfg)
    if d["X"]:
        kw["moe"] = MoEConfig(num_experts=d["X"], top_k=d["k"],
                              capacity_factor=port["moe_capacity_factor"])
    tc = getattr(models, port["factory"])(port["size"], **kw)
    arch = cfg["architecture"]
    stated = {"d_model": d["E"], "n_layers": d["L"], "n_heads": d["H"],
              "kv_heads": d["Hkv"], "head_dim": d["Dh"], "d_ff": d["F"],
              "vocab_size": d["V"],
              "norm": "rms" if arch["norm"] == "rmsnorm" else "ln",
              "pos": arch["positions"], "bias": arch["bias"],
              "tie_embeddings": cfg["tie_word_embeddings"]}
    if arch["positions"] == "rope":
        stated["rope_theta"] = cfg["rope_theta"]
    got = {k: getattr(tc, k) for k in stated}
    if got != stated:
        raise ValueError(f"the port's {port['factory']}({port['size']!r}) "
                         f"gives {got}, the configuration states {stated}")
    return tc


def engine_kwargs(cfg: dict, seed: int, device: str) -> dict:
    return dict(cfg["engine"], seed=seed, device=device)


class IdTokenizer:
    """Token ids as text: "17 4031 9" encodes to [17, 4031, 9]. No special
    tokens, so a request ends at its max_tokens."""

    eos_token_id = None

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str, **_kw) -> list[int]:
        return [int(t) for t in text.split()]

    def decode(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)


def _build_model(cfg: dict, seed: int, device=None, fault=None):
    import torch

    from ray_tpu_torch._device import resolve_device

    from gpubench import faults

    faults.plant_serving(fault)
    dev = resolve_device(device)
    tc = port_model(torch, cfg)
    return tc, weights.make(torch, cfg, seed, dev, tc.dtype)


@dataclasses.dataclass
class BenchLLMConfig(LLMConfig):
    """The port's LLMConfig whose model is the configuration file's, its
    weights the benchmark's, drawn where the engine is built."""

    bench_cfg: dict = dataclasses.field(default_factory=dict)
    bench_seed: int = 0
    bench_fault: str | None = None   # faults.py, for the checks' tests

    def build_model(self, device=None):
        return _build_model(self.bench_cfg, self.bench_seed, device,
                            self.bench_fault)


def llm_config(cfg: dict, seed: int, device: str, deployment: dict,
               fault: str | None = None) -> BenchLLMConfig:
    return BenchLLMConfig(
        model_loading_config=ModelLoadingConfig(
            model_id=cfg["name"], tokenizer=None),
        model_family=cfg["family"],
        engine_kwargs=engine_kwargs(cfg, seed, device),
        deployment_config=deployment, bench_cfg=cfg, bench_seed=seed,
        bench_fault=fault)


def bench_server(base):
    """The port's LLMServer with the benchmark's reads in the replica."""

    class BenchServer(base):
        def __init__(self, llm_config):
            super().__init__(llm_config)
            self.tokenizer = IdTokenizer(self.engine.cfg.vocab_size)
            self._slice = None

        def bench_device(self) -> dict:
            import torch

            from gpubench.common import forbidden_modules

            dev = self.engine.device
            out = {"forbidden": forbidden_modules(),
                   "platform": dev.type}
            if dev.type == "cuda":
                out.update(kind=torch.cuda.get_device_name(dev),
                           memory_peak_bytes=torch.cuda.max_memory_allocated(
                               dev))
            return out

        def bench_trace_start(self) -> float:
            import torch

            from gpubench import trace

            self._slice = trace.Slice(torch)
            return self._slice.t0

        def bench_trace_stop(self) -> float:
            """Ends the slice; its reduction waits for bench_trace_read,
            after the window, off the engine's way."""
            return self._slice.stop()

        def bench_trace_read(self) -> dict:
            sl, self._slice = self._slice, None
            return sl.read()

    BenchServer.__name__ = BenchServer.__qualname__ = base.__name__
    return BenchServer
