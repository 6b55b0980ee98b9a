"""The reference against the port at a small size on the CPU, both in
float32: the same forward for both families (the port's MoE at capacity
factor E/k drops no token, as the reference), the same loss, gradients
and AdamW steps; and the float8 control differs from both."""

import json
import os

import pytest
import torch

from gpubench import weights
from gpubench.reference import lowp, model
from gpubench.reference import train as ref_train

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def small(name, **kw):
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        c = json.load(f)
    c.update(kw)
    return c


def mixtral_small():
    from ray_tpu_torch.models import mixtral_config
    from ray_tpu_torch.models.transformer import MoEConfig

    c = small("mixtral-8x7b-l16", hidden_size=128, intermediate_size=192,
              num_hidden_layers=2, num_attention_heads=8,
              num_key_value_heads=2, vocab_size=300)
    # the port's RMSNorm eps, so the two compute the same function
    c["architecture"] = dict(c["architecture"], norm_eps=1e-6)
    port = mixtral_config("tiny", d_model=128, d_ff=192, n_layers=2,
                          n_heads=8, n_kv_heads=2, vocab_size=300,
                          max_seq_len=64, dtype=torch.float32,
                          moe=MoEConfig(8, 2, 4.0))
    return c, port


def gpt2_small():
    from ray_tpu_torch.models import gpt2_config

    c = small("gpt2-xl", n_embd=128, n_layer=2, n_head=4, vocab_size=300,
              n_positions=64)
    port = gpt2_config("124m", d_model=128, d_ff=512, n_layers=2,
                       n_heads=4, vocab_size=300, max_seq_len=64,
                       dtype=torch.float32)
    return c, port


def ref_logits(c, p, toks, precision="f32"):
    spec, mm = model.Spec(c), lowp.matmul(torch, precision)
    x = model.embed(torch, p, toks, spec)
    for i in range(spec.L):
        x = model.layer(torch, x, model.layer_params(p, i), spec, mm)
    return model.head(torch, x, p, spec, mm)


@pytest.mark.parametrize("make", [mixtral_small, gpt2_small],
                         ids=["mixtral", "gpt2"])
def test_forward_is_the_ports(make):
    from ray_tpu_torch.models import transformer

    c, port = make()
    assert transformer.param_shapes(port) == weights.param_shapes(c)
    p = weights.make(torch, c, 2 ** 31 + 9, "cpu", torch.float32)
    toks = torch.randint(0, 300, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    theirs, _ = transformer.forward(p, toks, port, attn_impl="reference")
    ours = ref_logits(c, p, toks)
    assert (theirs - ours).abs().max() < 1e-5
    low = ref_logits(c, p, toks, "fp8")
    assert (low - ours).abs().max() > 1e-2


def test_training_steps_are_the_ports():
    from ray_tpu_torch.models import transformer
    from ray_tpu_torch.train import adamw, make_train_step

    c, port = gpt2_small()
    port = type(port)(**{**port.__dict__, "remat": False})
    opt_cfg = {"learning_rate": 1e-3, "weight_decay": 0.01, "b1": 0.9,
               "b2": 0.999, "eps": 1e-8}
    gen = torch.Generator().manual_seed(3)
    batches = [torch.randint(0, 300, (4, 33), generator=gen)
               for _ in range(3)]
    p = weights.make(torch, c, 11, "cpu", torch.float32)
    named = list(weights.leaves(p))
    start = {"/".join(k): t.clone() for k, t in named}
    opt = adamw(p, opt_cfg["learning_rate"], weight_decay=0.01)
    step = make_train_step(
        lambda q, b: transformer.loss_fn(q, b, port, attn_impl="reference"),
        opt)
    losses = []
    for i, b in enumerate(batches):
        _, _, loss = step(p, None, b)
        losses.append(float(loss))
        if i == 0:
            grads = {"/".join(k): float(opt.state[t]["exp_avg"].norm() / 0.1)
                     for k, t in named}
    change = {"/".join(k): float((t.detach() - start["/".join(k)]).norm())
              for k, t in named}
    ref = ref_train.run(torch, c, 11, "cpu", batches, opt_cfg, micro=2)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    # a leaf whose gradient softmax cancels (the key bias) is round-off
    # on both sides: held against the median leaf, as check.py holds it
    g_med = sorted(ref["grad_norms"].values())[len(grads) // 2]
    c_med = sorted(ref["change_norms"].values())[len(grads) // 2]
    for name in grads:
        assert grads[name] == pytest.approx(ref["grad_norms"][name],
                                            rel=1e-3, abs=1e-4 * g_med), name
        assert change[name] == pytest.approx(ref["change_norms"][name],
                                             rel=1e-3, abs=1e-4 * c_med), name
