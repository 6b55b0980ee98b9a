"""Plain float32 PyTorch references of the benchmark's models.

``model.py`` is the published architectures' forward pass (Mixtral-8x7B's
RMSNorm, rotary, grouped-query attention and dropless top-2 experts;
GPT-2's LayerNorm, learned positions, biases, tanh-GELU and tied head),
written from their published descriptions over the param layout of
``gpubench/weights.py``; ``serve.py`` scores served tokens against it,
``train.py`` runs its loss, gradients and ``adamw.py``'s update for the
training cells, ``lowp.py`` is the float8 control. Departures from the
published models are listed in each configuration file.

Nothing here imports ``jax``, the JAX package or anything of the port, and
nothing takes what the port made: the weights and inputs are drawn again
from the seed.
"""


def strict_fp32(torch) -> None:
    """Float32 matmuls in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
