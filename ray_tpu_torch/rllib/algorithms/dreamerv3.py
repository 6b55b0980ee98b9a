"""DreamerV3 — model-based RL: learn a latent world model, act in dreams.

(reference: rllib/algorithms/dreamerv3/ — DreamerV3Config/DreamerV3 per
Hafner et al. 2023. Three jointly-trained pieces:
  1. WORLD MODEL: an RSSM with a deterministic GRU path h_t and a
     categorical stochastic state z_t (straight-through gradients),
     trained on replayed sequences by reconstruction + reward + continue
     prediction and the two KL terms (dynamics vs representation) with
     free bits,
  2. CRITIC: regresses symlog lambda-returns computed over imagined
     rollouts, with a slow EMA target for bootstrapping,
  3. ACTOR: REINFORCE on imagined trajectories with advantages normalized
     by an EMA of the return percentile range, plus an entropy bonus.)

Scaled to the built-in vector envs (MLP encoder/decoder, small RSSM); the
architecture, loss structure, and training loop match the paper.

The params, the slow critic, the return EMA and the three Adam states live
on the learner's device (the card unless the caller asks for the CPU); the
RSSM's roll over a sequence and the imagination are loops over time on that
device. The runners are CPU actors carrying the recurrent state. Every draw
comes from an explicit ``torch.Generator``: a categorical sample is the
argmax of the log-probs plus Gumbel draws, and an update or a policy step
takes those draws as ``noise=`` where a caller must fix them.

Alignment convention: the RSSM consumes the PREVIOUS action at every step
(training and acting identically; is_first masks it at episode starts).
rewards[t]/dones[t] are the outcome of the action taken at t, and the
lambda-return indexing matches that; the reward/continue heads therefore
predict outcome-at-t marginalized over the current action (exact for
state-determined rewards, a small bias otherwise — the auto-resetting
vector envs drop the terminal observation, which rules out the paper's
arrival-indexed storage).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib import learner as learner_mod
from ray_tpu_torch.rllib import rl_module
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import snapshot
from ray_tpu_torch.rllib.algorithms.sac import (_check_keys, _convert_mlp,
                                                _step, _to_tensor)
from ray_tpu_torch.rllib.env import make_vec_env
from ray_tpu_torch.rllib.env_runner import RUNNER_NUM_CPUS, _runner_torch

PARAM_KEYS = ("encoder", "gru", "prior", "posterior", "decoder", "reward",
              "continue", "actor", "critic")
WM_KEYS = PARAM_KEYS[:7]
# the subtrees a runner's policy step reads
RUNNER_KEYS = ("encoder", "gru", "posterior", "actor")
GRAD_CLIP = 100.0  # elementwise, on the world model's gradients


def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


class DreamerV3Config(AlgorithmConfig):
    algo_class = None  # set below

    def __init__(self):
        super().__init__()
        self.model_hidden = (128,)
        self.deter_dim = 128           # GRU (deterministic) state
        self.stoch_classes = 8         # categorical classes per latent
        self.stoch_dims = 8            # number of categorical latents
        self.embed_dim = 64
        self.batch_size_B = 16         # sequences per world-model batch
        self.batch_length_T = 32       # timesteps per sequence
        self.horizon_H = 15            # imagination horizon
        self.buffer_size = 50_000
        self.num_updates_per_step = 8
        self.learning_starts = 1_000
        self.gae_lambda = 0.95
        self.entropy_scale = 3e-3
        self.critic_ema_decay = 0.98
        self.free_bits = 1.0
        self.kl_dyn_scale = 0.5
        self.kl_rep_scale = 0.1
        self.world_lr = 6e-4
        self.actor_lr = 3e-4
        self.critic_lr = 3e-4

    def training(self, *, batch_size_B=None, batch_length_T=None,
                 horizon_H=None, num_updates_per_step=None,
                 learning_starts=None, entropy_scale=None, world_lr=None,
                 actor_lr=None, critic_lr=None, **kwargs) -> "DreamerV3Config":
        super().training(**kwargs)
        for name, val in (("batch_size_B", batch_size_B),
                          ("batch_length_T", batch_length_T),
                          ("horizon_H", horizon_H),
                          ("num_updates_per_step", num_updates_per_step),
                          ("learning_starts", learning_starts),
                          ("entropy_scale", entropy_scale),
                          ("world_lr", world_lr), ("actor_lr", actor_lr),
                          ("critic_lr", critic_lr)):
            if val is not None:
                setattr(self, name, val)
        return self


# ------------------------------------------------------------------ modules


def _dense_init(generator: torch.Generator, sizes, device=None) -> dict:
    """He-normal weights in [in, out] layout, zero biases, drawn from
    `generator` on its own device and placed on `device` (None: the card)."""
    device = resolve_device(device)
    params = {}
    for i in range(len(sizes) - 1):
        w = torch.randn((sizes[i], sizes[i + 1]), generator=generator,
                        device=generator.device) * math.sqrt(2.0 / sizes[i])
        params[str(i)] = {"w": w.to(device),
                          "b": torch.zeros(sizes[i + 1], device=device)}
    return params


def _dense(params: dict, x, act=F.silu, final_linear: bool = True):
    n = len(params)
    for i in range(n):
        layer = params[str(i)]
        x = x @ layer["w"] + layer["b"]
        if i < n - 1 or not final_linear:
            x = act(x)
    return x


def _gru_init(generator: torch.Generator, in_dim: int, hidden: int,
              device=None) -> dict:
    device = resolve_device(device)
    scale = math.sqrt(1.0 / (in_dim + hidden))
    wi = torch.randn((in_dim, 3 * hidden), generator=generator,
                     device=generator.device) * scale
    wh = torch.randn((hidden, 3 * hidden), generator=generator,
                     device=generator.device) * scale
    return {"wi": wi.to(device), "wh": wh.to(device),
            "b": torch.zeros(3 * hidden, device=device)}


def _gru(params: dict, x, h):
    """The reference's cell: the reset gate scales the candidate's own
    pre-activation, cand = tanh(r * c) (not torch.nn.GRUCell's form)."""
    gates = x @ params["wi"] + h @ params["wh"] + params["b"]
    r, u, c = gates.chunk(3, dim=-1)
    r, u = torch.sigmoid(r), torch.sigmoid(u)
    cand = torch.tanh(r * c)
    return u * h + (1.0 - u) * cand


def init_dreamer_params(generator: torch.Generator, obs_dim: int,
                        num_actions: int, cfg: DreamerV3Config,
                        device=None) -> dict:
    """The reference's nine subtrees, drawn in their order from
    `generator` (a CPU generator gives the same init on every device) and
    placed on `device` (None: the card)."""
    device = resolve_device(device)
    S, C = cfg.stoch_dims, cfg.stoch_classes
    z_dim = S * C
    feat = cfg.deter_dim + z_dim
    hid = tuple(cfg.model_hidden)
    return {
        "encoder": _dense_init(generator, (obs_dim, *hid, cfg.embed_dim),
                               device),
        "gru": _gru_init(generator, z_dim + num_actions, cfg.deter_dim,
                         device),
        "prior": _dense_init(generator, (cfg.deter_dim, *hid, z_dim), device),
        "posterior": _dense_init(generator, (cfg.deter_dim + cfg.embed_dim,
                                             *hid, z_dim), device),
        "decoder": _dense_init(generator, (feat, *hid, obs_dim), device),
        "reward": _dense_init(generator, (feat, *hid, 1), device),
        "continue": _dense_init(generator, (feat, *hid, 1), device),
        "actor": _dense_init(generator, (feat, *hid, num_actions), device),
        "critic": _dense_init(generator, (feat, *hid, 1), device),
    }


def params_from_jax(tree, device=None) -> dict:
    """The JAX package's numpy-leaf DreamerV3 tree (the nine subtrees of
    ``init_dreamer_params``) → the port's tensors on `device` (None: the
    card). Keys and shapes are checked: every MLP chains from what it reads
    to what it gives, the GRU reads [z, action] and keeps a state of its
    width, the value heads give one output."""
    device = resolve_device(device)
    _check_keys(tree, PARAM_KEYS, "<root>")
    gru = tree["gru"]
    _check_keys(gru, ("wi", "wh", "b"), "gru")
    g = {k: _to_tensor(gru[k], device, f"gru/{k}") for k in ("wi", "wh", "b")}
    D = g["wh"].shape[0]
    if g["wh"].dim() != 2 or tuple(g["wh"].shape) != (D, 3 * D):
        raise ValueError(f"param gru/wh has shape {tuple(g['wh'].shape)}, "
                         f"expected [deter, 3 * deter]")
    if g["wi"].dim() != 2 or g["wi"].shape[1] != 3 * D:
        raise ValueError(f"param gru/wi has shape {tuple(g['wi'].shape)}, "
                         f"expected [z + actions, {3 * D}]")
    if tuple(g["b"].shape) != (3 * D,):
        raise ValueError(f"param gru/b has shape {tuple(g['b'].shape)}, "
                         f"expected ({3 * D},)")
    out = {"gru": g}
    out["encoder"] = _convert_mlp(tree["encoder"], device, "encoder")
    obs_dim = out["encoder"]["0"]["w"].shape[0]
    embed = out["encoder"][str(len(out["encoder"]) - 1)]["w"].shape[1]
    out["prior"] = _convert_mlp(tree["prior"], device, "prior", D)
    z_dim = out["prior"][str(len(out["prior"]) - 1)]["w"].shape[1]
    num_actions = g["wi"].shape[0] - z_dim
    if num_actions < 1:
        raise ValueError(f"param gru/wi reads {g['wi'].shape[0]} inputs, "
                         f"expected z ({z_dim}) and the actions")
    feat = D + z_dim
    for name, width_in, width_out in (
            ("posterior", D + embed, z_dim), ("decoder", feat, obs_dim),
            ("reward", feat, 1), ("continue", feat, 1),
            ("actor", feat, num_actions), ("critic", feat, 1)):
        out[name] = _convert_mlp(tree[name], device, name, width_in,
                                 width_out)
    return {k: out[k] for k in PARAM_KEYS}


def gumbel(generator: torch.Generator, shape, like: torch.Tensor):
    """Standard Gumbel draws -log(-log(U)) of `shape` from `generator`, on
    `like`'s device and dtype; U is kept inside (0, 1)."""
    finfo = torch.finfo(like.dtype)
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=like.dtype).clamp_(finfo.tiny, 1.0 - finfo.eps)
    return (-torch.log(-torch.log(u))).to(like.device)


def _categorical(logits, generator=None, noise=None):
    """jax.random.categorical's rule: argmax(logits + Gumbel draws);
    `noise` (the logits' shape) takes the place of draws from
    `generator`."""
    if noise is None:
        noise = gumbel(generator, logits.shape, logits)
    return torch.argmax(logits + noise, dim=-1)


def _unimix(logits, S: int, C: int):
    """Latent logits [..., S * C] → probs [..., S, C] with the paper's
    unimix: 1% uniform smoothing keeps log-probs finite."""
    lg = logits.reshape(*logits.shape[:-1], S, C)
    return 0.99 * torch.softmax(lg, dim=-1) + 0.01 / C


def _sample_z(logits, generator, S: int, C: int, noise=None):
    """Straight-through categorical sample: one-hot forward, probs grad.
    `noise` [..., S, C] are the Gumbel draws."""
    probs = _unimix(logits, S, C)
    lg = torch.log(probs)
    idx = _categorical(lg.detach(), generator, noise)
    onehot = F.one_hot(idx, C).to(lg.dtype)
    st = onehot + probs - probs.detach()
    return st.reshape(*logits.shape[:-1], S * C), lg


def _kl_cat(lg_p, lg_q):
    """KL(p || q) for stacked categorical logits [.., S, C], summed over S."""
    p = torch.exp(lg_p)
    return torch.sum(p * (lg_p - lg_q), dim=(-2, -1))


def _sigmoid_bce(logits, labels):
    """optax.sigmoid_binary_cross_entropy."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


# ------------------------------------------------------------- world model


def make_world_model_update(optimizer: torch.optim.Optimizer,
                            cfg: DreamerV3Config, num_actions: int):
    """-> update(wm_params, batch, generator=None, noise=None) → (feats,
    metrics): one step of `optimizer` (over exactly the seven world-model
    subtrees' leaves, updated in place) on the reference's loss, the
    gradients clipped elementwise to [-100, 100]. `batch` is time-major
    [T, B, ...] with ``actions_onehot`` the previous actions; `noise` [T, B,
    S, C] are the Gumbel draws of the posterior samples (the prior's sample
    uses the same draws and is thrown away). `feats` [T, B, feat] come back
    detached; the metrics stay device tensors (``learner.floats``)."""
    S, C = cfg.stoch_dims, cfg.stoch_classes

    def rssm_observe(p, obs_seq, act_seq, is_first, generator, noise):
        """Teacher-forced posterior roll: obs/act [T, B, .] → features,
        prior/posterior logits. is_first resets the recurrent state."""
        T, B = obs_seq.shape[:2]
        embed = _dense(p["encoder"], obs_seq)
        if noise is None:
            noise = gumbel(generator, (T, B, S, C), obs_seq)
        h = torch.zeros((B, cfg.deter_dim), device=obs_seq.device)
        z = torch.zeros((B, S * C), device=obs_seq.device)
        hs, zs, posts = [], [], []
        for t in range(T):
            mask = (1.0 - is_first[t])[:, None]
            h, z = h * mask, z * mask
            a_t = act_seq[t] * mask
            h = _gru(p["gru"], torch.cat([z, a_t], -1), h)
            post_lg = _dense(p["posterior"], torch.cat([h, embed[t]], -1))
            z, post_lgn = _sample_z(post_lg, None, S, C, noise[t])
            hs.append(h)
            zs.append(z)
            posts.append(post_lgn)
        hs = torch.stack(hs)
        # the prior reads only h_t, so it runs once over all steps; its
        # sample (the posterior's draws) is unused: only its log-probs
        # enter the KL terms
        prior_lg = torch.log(_unimix(_dense(p["prior"], hs), S, C))
        feats = torch.cat([hs, torch.stack(zs)], -1)
        return feats, prior_lg, torch.stack(posts)

    def update(wm_params, batch, generator=None, noise=None):
        p = wm_params
        feats, prior_lg, post_lg = rssm_observe(
            p, batch["obs"], batch["actions_onehot"], batch["is_first"],
            generator, noise)
        recon = _dense(p["decoder"], feats)
        recon_loss = torch.mean(torch.sum(
            (recon - symlog(batch["obs"])) ** 2, -1))
        rew_pred = _dense(p["reward"], feats)[..., 0]
        rew_loss = torch.mean((rew_pred - symlog(batch["rewards"])) ** 2)
        cont_logit = _dense(p["continue"], feats)[..., 0]
        cont = 1.0 - batch["dones"].to(torch.float32)
        cont_loss = torch.mean(_sigmoid_bce(cont_logit, cont))
        dyn_kl = _kl_cat(post_lg.detach(), prior_lg)
        rep_kl = _kl_cat(post_lg, prior_lg.detach())
        kl_loss = (cfg.kl_dyn_scale
                   * torch.mean(torch.clamp(dyn_kl, min=cfg.free_bits))
                   + cfg.kl_rep_scale
                   * torch.mean(torch.clamp(rep_kl, min=cfg.free_bits)))
        loss = recon_loss + rew_loss + cont_loss + kl_loss
        leaves = learner_mod.leaves(p)
        grads = torch.autograd.grad(loss, leaves)
        torch._foreach_clamp_min_(grads, -GRAD_CLIP)
        torch._foreach_clamp_max_(grads, GRAD_CLIP)
        for t, g in zip(leaves, grads):
            t.grad = g
        optimizer.step()
        metrics = {"wm_recon": recon_loss.detach(),
                   "wm_reward": rew_loss.detach(),
                   "wm_continue": cont_loss.detach(),
                   "wm_kl": torch.mean(dyn_kl.detach()),
                   "wm_loss": loss.detach()}
        return feats.detach(), metrics

    return update


# ------------------------------------------------------- imagination phase


@torch.no_grad()
def imagine(params: dict, feats0, cfg: DreamerV3Config, num_actions: int,
            generator=None, noise=None):
    """Roll the dynamics forward H steps from the real posterior states
    `feats0` [N, feat], actions sampled from the actor; untracked (the
    sampled actions and the frozen world model carry no gradient).
    Returns (feats [H, N, feat], actions [H, N]): feats[t] is the feature
    before step t's transition. `noise` {"action": [H, N, A], "z": [H, N,
    S, C]} are the Gumbel draws."""
    S, C, H = cfg.stoch_dims, cfg.stoch_classes, cfg.horizon_H
    N = feats0.shape[0]
    if noise is None:
        noise = {"action": gumbel(generator, (H, N, num_actions), feats0),
                 "z": gumbel(generator, (H, N, S, C), feats0)}
    h, z = feats0[:, :cfg.deter_dim], feats0[:, cfg.deter_dim:]
    feats, acts = [], []
    for t in range(H):
        feat = torch.cat([h, z], -1)
        a_lg = torch.log_softmax(_dense(params["actor"], feat), dim=-1)
        a = _categorical(a_lg, noise=noise["action"][t])
        a_1h = F.one_hot(a, num_actions).to(feat.dtype)
        h = _gru(params["gru"], torch.cat([z, a_1h], -1), h)
        z, _ = _sample_z(_dense(params["prior"], h), None, S, C,
                         noise["z"][t])
        feats.append(feat)
        acts.append(a)
    return torch.stack(feats), torch.stack(acts)


def make_dream_update(actor_opt: torch.optim.Optimizer,
                      critic_opt: torch.optim.Optimizer,
                      cfg: DreamerV3Config, num_actions: int):
    """-> update(params, slow_critic, ret_ema, feats0, generator=None,
    noise=None) → (ret_ema, metrics): imagine H steps from the real
    posterior states `feats0` [N, feat] with the world model frozen, step
    the actor (REINFORCE on normalized λ-return advantages plus entropy),
    then the critic toward symlog λ-returns, then the slow critic toward
    the updated critic; all in place. `noise` {"action": [H, N, A], "z":
    [H, N, S, C]} are the Gumbel draws of the imagined actions and
    latents. The metrics stay device tensors."""
    H = cfg.horizon_H

    @torch.no_grad()
    def lambda_returns(params, slow_critic, feats):
        rew = symexp(_dense(params["reward"], feats)[..., 0])
        cont = torch.sigmoid(_dense(params["continue"], feats)[..., 0])
        vals = symexp(_dense(slow_critic, feats)[..., 0])
        disc = cont * cfg.gamma
        rets = torch.empty_like(vals[:-1])
        nxt = vals[-1]
        for t in range(H - 2, -1, -1):
            nxt = rew[t] + disc[t] * ((1 - cfg.gae_lambda) * vals[t + 1]
                                      + cfg.gae_lambda * nxt)
            rets[t] = nxt
        return rets, vals, disc

    def update(params, slow_critic, ret_ema, feats0, generator=None,
               noise=None):
        feats, acts = imagine(params, feats0, cfg, num_actions, generator,
                              noise)
        rets, vals, disc = lambda_returns(params, slow_critic, feats)
        # normalize advantages by an EMA of the return spread (paper:
        # 95th-5th percentile, floored at 1)
        flat = rets.reshape(-1)
        lo = torch.quantile(flat, 0.05, interpolation="linear")
        hi = torch.quantile(flat, 0.95, interpolation="linear")
        spread = torch.clamp(hi - lo, min=1.0)
        adv = (rets - vals[:-1]) / torch.clamp(ret_ema, min=1.0)
        # discount-weight trajectories by survival probability
        weight = torch.cumprod(torch.cat(
            [torch.ones_like(disc[:1]), disc[:-1]], 0), 0)[:-1]
        # the actor's log-probs and entropies, tracked through its leaves
        # only: the features are untracked inputs
        a_lg = torch.log_softmax(_dense(params["actor"], feats), dim=-1)
        logps = a_lg.gather(-1, acts[..., None])[..., 0]
        ents = -torch.sum(torch.exp(a_lg) * a_lg, -1)
        pg = -torch.mean(weight * adv * logps[:-1])
        ent_bonus = -cfg.entropy_scale * torch.mean(weight * ents[:-1])
        a_loss = pg + ent_bonus
        _step(actor_opt, a_loss, learner_mod.leaves(params["actor"]))

        # critic: symlog regression toward the lambda-returns
        v = _dense(params["critic"], feats[:-1])[..., 0]
        c_loss = torch.mean(weight * (v - symlog(rets)) ** 2)
        _step(critic_opt, c_loss, learner_mod.leaves(params["critic"]))

        with torch.no_grad():
            slow, online = (learner_mod.leaves(slow_critic),
                            learner_mod.leaves(params["critic"]))
            torch._foreach_mul_(slow, cfg.critic_ema_decay)
            torch._foreach_add_(slow, online,
                                alpha=1 - cfg.critic_ema_decay)
            new_ema = 0.99 * ret_ema + 0.01 * spread
        metrics = {"actor_loss": a_loss.detach(),
                   "critic_loss": c_loss.detach(),
                   "dream_return": torch.mean(rets),
                   "actor_entropy": torch.mean(ents.detach())}
        return new_ema, metrics

    return update


# --------------------------------------------------------------- env runner


def policy_step(params: dict, h, z, obs, prev_a, first, num_actions: int,
                S: int, C: int, generator=None, noise=None):
    """The acting policy's step: reset (h, z) where an episode starts,
    advance the GRU on the previous action, sample z from the posterior,
    sample an action from the actor's logits. `noise` {"z": [N, S, C],
    "action": [N, A]} are the Gumbel draws. Returns (h, z, a)."""
    if noise is None:
        noise = {"z": gumbel(generator, (obs.shape[0], S, C), obs),
                 "action": gumbel(generator, (obs.shape[0], num_actions),
                                  obs)}
    mask = (1.0 - first)[:, None]
    h, z = h * mask, z * mask
    a_1h = F.one_hot(prev_a, num_actions).to(obs.dtype) * mask
    e = _dense(params["encoder"], obs)
    h = _gru(params["gru"], torch.cat([z, a_1h], -1), h)
    post_lg = _dense(params["posterior"], torch.cat([h, e], -1))
    z, _ = _sample_z(post_lg, None, S, C, noise["z"])
    logits = _dense(params["actor"], torch.cat([h, z], -1))
    return h, z, _categorical(logits, noise=noise["action"])


def _tensors(tree, device) -> dict:
    """A numpy-leaf subtree (a weight blob's) → tensors on `device`."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return rl_module._to_tensor(tree).to(device)


@ray_tpu_torch.remote(num_cpus=RUNNER_NUM_CPUS, num_gpus=0)
class _DreamerRunner:
    """Remote rollout actor carrying the recurrent (h, z) policy state
    across sample() calls; the world-model + actor params are shipped
    per call like the other off-policy runners (a CPU copy, one torch
    thread, a seeded generator)."""

    def __init__(self, env_id, num_envs: int, cfg_blob: bytes,
                 seed: int = 0):
        from ray_tpu_torch._private import serialization as ser

        self.gen = _runner_torch(seed)
        self.cfg = ser.loads(cfg_blob)
        self.env = make_vec_env(env_id, num_envs, seed)
        self.obs = self.env.reset(seed)
        self.num_actions = self.env.num_actions
        cfg = self.cfg
        N = num_envs
        self.h = torch.zeros((N, cfg.deter_dim))
        self.z = torch.zeros((N, cfg.stoch_dims * cfg.stoch_classes))
        self.prev_action = np.zeros((N,), np.int64)
        self.first = np.ones((N,), np.float32)

    def sample(self, params_blob: bytes, num_steps: int,
               random_actions: bool = False) -> dict:
        from ray_tpu_torch._private import serialization as ser

        cfg = self.cfg
        params = None if random_actions else _tensors(
            ser.loads(params_blob), "cpu")
        N = self.env.num_envs
        obs_l, act_l, prev_l, rew_l, done_l, first_l = [], [], [], [], [], []
        for _ in range(num_steps):
            # prev_actions[t] = action taken BEFORE observing obs_t — the
            # exact input the acting policy's GRU consumed, so training
            # sequences reproduce the same action alignment (is_first
            # masks it at episode starts)
            prev_l.append(self.prev_action.copy())
            if random_actions:
                a = torch.randint(0, self.num_actions, (N,),
                                  generator=self.gen).numpy()
            else:
                with torch.no_grad():
                    self.h, self.z, a = policy_step(
                        params, self.h, self.z,
                        torch.as_tensor(self.obs, dtype=torch.float32),
                        torch.as_tensor(self.prev_action),
                        torch.as_tensor(self.first), self.num_actions,
                        cfg.stoch_dims, cfg.stoch_classes, self.gen)
                a = a.numpy()
            obs_l.append(self.obs.copy())
            first_l.append(self.first.copy())
            nxt, r, d, _ = self.env.step(a)
            act_l.append(a)
            rew_l.append(r)
            done_l.append(d)
            self.obs = nxt
            self.prev_action = a
            self.first = d.astype(np.float32)
        return {
            "obs": np.stack(obs_l, 1),        # [N, T, obs]
            "actions": np.stack(act_l, 1),
            "prev_actions": np.stack(prev_l, 1),
            "rewards": np.stack(rew_l, 1),
            "dones": np.stack(done_l, 1),
            "is_first": np.stack(first_l, 1),
            "episode_returns": self.env.drain_episode_returns(),
        }

    def ping(self) -> bool:
        """Readiness probe, as EnvRunner's."""
        return True


class _SequenceBuffer:
    """Stores per-env streams; samples [B, T] windows uniformly."""

    def __init__(self, capacity_steps: int, obs_dim: int, seed: int = 0):
        self.capacity = capacity_steps
        self.obs_dim = obs_dim
        self.streams: list[dict] = []
        self.rng = np.random.default_rng(seed)
        self.size = 0

    def add_rollout(self, batch: dict):
        N = batch["obs"].shape[0]
        for i in range(N):
            self.streams.append({
                "obs": batch["obs"][i], "actions": batch["actions"][i],
                "prev_actions": batch["prev_actions"][i],
                "rewards": batch["rewards"][i], "dones": batch["dones"][i],
                "is_first": batch["is_first"][i]})
            self.size += batch["obs"].shape[1]
        while self.size > self.capacity and len(self.streams) > 1:
            dead = self.streams.pop(0)
            self.size -= len(dead["rewards"])

    def sample(self, B: int, T: int) -> dict | None:
        eligible = [s for s in self.streams if len(s["rewards"]) >= T]
        if not eligible:
            return None
        out = {k: [] for k in ("obs", "actions", "prev_actions", "rewards",
                               "dones", "is_first")}
        for _ in range(B):
            s = eligible[self.rng.integers(0, len(eligible))]
            lo = self.rng.integers(0, len(s["rewards"]) - T + 1)
            for k in out:
                out[k].append(s[k][lo:lo + T])
        return {k: np.stack(v) for k, v in out.items()}  # [B, T, ...]


def time_major(batch: dict, num_actions: int) -> dict:
    """A buffer window [B, T, ...] → the world model's numpy inputs
    [T, B, ...]: the RSSM consumes the PREVIOUS action at each step,
    one-hot, matching the acting policy."""
    prev = np.swapaxes(batch["prev_actions"], 0, 1)
    return {
        "obs": np.ascontiguousarray(np.swapaxes(batch["obs"], 0, 1)),
        "actions_onehot": np.eye(num_actions, dtype=np.float32)[prev],
        "rewards": np.ascontiguousarray(np.swapaxes(batch["rewards"], 0, 1)),
        "dones": np.ascontiguousarray(np.swapaxes(batch["dones"], 0, 1)),
        "is_first": np.swapaxes(batch["is_first"], 0, 1).astype(np.float32),
    }


class DreamerV3(Algorithm):
    def _setup(self):
        cfg = self.config
        probe = make_vec_env(cfg.env_id, 1, cfg.seed)
        if probe.num_actions < 1:
            raise ValueError("DreamerV3 here supports discrete-action envs")
        self.obs_dim = probe.obs_dim
        self.num_actions = probe.num_actions
        # drawn on the CPU, so a seed gives the same init on every device
        self.params = init_dreamer_params(
            torch.Generator().manual_seed(cfg.seed), self.obs_dim,
            self.num_actions, cfg, device=self.device)
        # a detached clone: the critic's Adam updates its leaves in place
        self.slow_critic = snapshot(self.params["critic"])
        self.world_opt = learner_mod.make_optimizer(
            {k: self.params[k] for k in WM_KEYS}, cfg.world_lr)
        self.actor_opt = learner_mod.make_optimizer(self.params["actor"],
                                                    cfg.actor_lr)
        self.critic_opt = learner_mod.make_optimizer(self.params["critic"],
                                                     cfg.critic_lr)
        self.ret_ema = torch.ones((), device=self.device)
        self._wm_update = make_world_model_update(self.world_opt, cfg,
                                                  self.num_actions)
        self._dream_update = make_dream_update(
            self.actor_opt, self.critic_opt, cfg, self.num_actions)
        from ray_tpu_torch._private import serialization as ser

        cfg_blob = ser.dumps(cfg)
        self.runners = [
            _DreamerRunner.remote(cfg.env_id, cfg.num_envs_per_runner,
                                  cfg_blob, cfg.seed + 1000 * (i + 1))
            for i in range(cfg.num_env_runners)]
        self.buffer = _SequenceBuffer(cfg.buffer_size, self.obs_dim,
                                      seed=cfg.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 13)
        self._env_steps = 0
        self._num_updates = 0

    def training_step(self) -> dict:
        cfg = self.config
        from ray_tpu_torch._private import serialization as ser

        warmup = self._env_steps < cfg.learning_starts
        blob = ser.dumps(rl_module.to_numpy(
            {k: self.params[k] for k in RUNNER_KEYS}))
        refs = [r.sample.remote(blob, cfg.rollout_fragment_length,
                                random_actions=warmup)
                for r in self.runners]
        for s in ray_tpu_torch.get(refs, timeout=300):
            self.buffer.add_rollout(s)
            self._env_steps += int(s["rewards"].size)
            self._episode_returns.extend(s["episode_returns"])
        metrics: dict = {"env_steps": self._env_steps}
        if warmup:
            return metrics
        m: dict = {}
        for _ in range(cfg.num_updates_per_step):
            batch = self.buffer.sample(cfg.batch_size_B, cfg.batch_length_T)
            if batch is None:
                break
            jb = learner_mod.batch_to(time_major(batch, self.num_actions),
                                      self.device)
            feats, m = self._wm_update(
                {k: self.params[k] for k in WM_KEYS}, jb, self.generator)
            feats0 = feats.reshape(-1, feats.shape[-1])
            self.ret_ema, dm = self._dream_update(
                self.params, self.slow_critic, self.ret_ema, feats0,
                self.generator)
            m.update(dm)
            self._num_updates += 1
        metrics.update(learner_mod.floats(m))
        metrics["num_updates"] = self._num_updates
        return metrics

    def compute_single_action(self, obs, noise=None) -> int:
        """Greedy action through the posterior-free prior path is not
        meaningful without history; evaluation uses the actor on a
        fresh posterior step with empty recurrent state. The posterior's
        sample draws from a generator seeded 0 unless `noise` [1, S, C]
        gives the Gumbel draws."""
        cfg = self.config
        S, C = cfg.stoch_dims, cfg.stoch_classes
        p = self.params
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(obs, np.float32),
                                device=self.device)[None]
            e = _dense(p["encoder"], x)
            h = torch.zeros((1, cfg.deter_dim), device=self.device)
            z = torch.zeros((1, S * C), device=self.device)
            h = _gru(p["gru"], torch.cat(
                [z, torch.zeros((1, self.num_actions), device=self.device)],
                -1), h)
            post_lg = _dense(p["posterior"], torch.cat([h, e], -1))
            if noise is None:
                noise = gumbel(torch.Generator(device=self.device)
                               .manual_seed(0), (1, S, C), x)
            z, _ = _sample_z(post_lg, None, S, C, noise)
            logits = _dense(p["actor"], torch.cat([h, z], -1))
            return int(torch.argmax(logits[0]))

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self.runners.clear()


DreamerV3Config.algo_class = DreamerV3
