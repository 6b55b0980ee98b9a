"""Served tokens judged against the reference.

Each sampled request is its prompt followed by the tokens the program
served. The reference runs that sequence once, teacher-forced, and at
each served position reads how far the served token's logit lies below
its best logit (0 where they agree). The control (``precision="fp8"``)
runs the same sequences in float8 and reads the same gap for the token
the float8 model puts first (``"bf16"`` the same with bfloat16 matmuls); ``"published"`` reads the served token's gap
under the published model where the reference follows a departure of the
port (``model.Spec``), as a witness of what that departure costs.

The weights are drawn again from the seed in the served type and each
layer is taken to float32 as it is reached, so the whole bf16 model and
one layer in float32 are resident at once; every sequence passes a layer
before the next is made.
"""

from __future__ import annotations

from gpubench import weights
from gpubench.reference import lowp, model, strict_fp32


def served_gaps(torch, cfg: dict, seed: int, device, seqs: list,
                precisions=("f32",)) -> list[dict]:
    """seqs: [(token ids, prompt length)]. Returns, per sequence, "gap":
    the float32 reference's gap of each served token, "margin": the
    smallest routing margin over the layers at the position that chose it
    (MoE models); with "fp8" in `precisions`, "control": its gap of
    the float8 model's first choice; with "bf16", "bf16": its gap of the
    first choice of the model with bf16 matmuls (what rounding alone
    costs); with "published", "published": the served token's gap under
    the published model."""
    strict_fp32(torch)
    specs = {p: model.Spec(cfg, published=p == "published")
             for p in precisions}
    spec = specs["f32"]
    master = weights.make(torch, cfg, seed, device, torch.bfloat16)
    mms = {p: lowp.matmul(torch, "f32" if p == "published" else p)
           for p in precisions}
    with torch.no_grad():
        toks = [torch.as_tensor(ids, device=device)[None] for ids, _ in seqs]
        xs = {p: [model.embed(torch, master, t, spec) for t in toks]
              for p in precisions}
        # each token's nearest tie between its chosen experts and the next
        margin = [None] * len(seqs)
        for i in range(spec.L):
            lp = model.layer_params(master, i)
            for p in precisions:
                out = []
                for j, x in enumerate(xs[p]):
                    m = [] if p == "f32" and spec.X else None
                    out.append(model.layer(torch, x, lp, specs[p], mms[p],
                                           m))
                    if m:
                        margin[j] = m[0] if margin[j] is None \
                            else torch.minimum(margin[j], m[0])
                xs[p] = out
            del lp
        out = []
        for j, (ids, n) in enumerate(seqs):
            rows = slice(n - 1, len(ids) - 1)
            served = torch.as_tensor(ids[n:], device=device)
            ref = model.head(torch, xs["f32"][j][0, rows], master, spec,
                             mms["f32"])
            best = ref.max(-1).values
            rec = {"gap": (best - ref.gather(1, served[:, None])[:, 0])
                   .cpu().tolist()}
            if margin[j] is not None:
                rec["margin"] = margin[j][0, rows].cpu().tolist()
            if "published" in precisions:
                pub = model.head(torch, xs["published"][j][0, rows], master,
                                 specs["published"], mms["published"])
                rec["published"] = (pub.max(-1).values
                                    - pub.gather(1, served[:, None])[:, 0]
                                    ).cpu().tolist()
            for p, key in (("fp8", "control"), ("bf16", "bf16")):
                if p in precisions:
                    low = model.head(torch, xs[p][j][0, rows], master, spec,
                                     mms[p])
                    pick = low.argmax(-1)
                    rec[key] = (best - ref.gather(1, pick[:, None])[:, 0]
                                ).cpu().tolist()
            out.append(rec)
    del master, xs
    return out
