"""SAC: soft actor-critic for continuous control.

(reference: rllib/algorithms/sac/ — SACConfig/SAC with twin Q networks,
polyak-averaged targets, tanh-squashed Gaussian policy, and automatic
entropy-temperature tuning; Haarnoja et al. 2018. Off-policy like DQN:
remote env runners fill the replay buffer, the learner runs updates over
uniform samples.)

The params, the target twins and the three Adam states live on the
learner's device (the card unless the caller asks for the CPU); the
runners are CPU actors with a CPU copy of the actor. Every draw comes
from an explicit ``torch.Generator``; an update takes its Gaussian draws
as ``noise=`` where a caller must fix them.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib import learner as learner_mod
from ray_tpu_torch.rllib import rl_module
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, _merge
from ray_tpu_torch.rllib.algorithms.dqn import snapshot
from ray_tpu_torch.rllib.env import make_vec_env
from ray_tpu_torch.rllib.env_runner import RUNNER_NUM_CPUS, _runner_torch
from ray_tpu_torch.rllib.replay import ReplayBuffer

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
_LOG_2 = math.log(2.0)


class SACConfig(AlgorithmConfig):
    algo_class = None  # set below

    def __init__(self):
        super().__init__()
        self.buffer_size = 100_000
        self.train_batch_size = 128
        self.tau = 0.005                  # polyak for target critics
        self.num_updates_per_step = 16
        self.learning_starts = 1_000
        self.initial_alpha = 0.1
        self.autotune_alpha = True
        self.target_entropy = None        # default: -action_dim

    def training(self, *, buffer_size=None, train_batch_size=None, tau=None,
                 num_updates_per_step=None, learning_starts=None,
                 initial_alpha=None, autotune_alpha=None,
                 target_entropy=None, **kwargs) -> "SACConfig":
        super().training(**kwargs)
        for name, val in (("buffer_size", buffer_size),
                          ("train_batch_size", train_batch_size),
                          ("tau", tau),
                          ("num_updates_per_step", num_updates_per_step),
                          ("learning_starts", learning_starts),
                          ("initial_alpha", initial_alpha),
                          ("autotune_alpha", autotune_alpha),
                          ("target_entropy", target_entropy)):
            if val is not None:
                setattr(self, name, val)
        return self


# ------------------------------------------------------------- sac networks


def _mlp_init(generator: torch.Generator, sizes, device=None) -> dict:
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


def _mlp(params: dict, x, final_linear: bool = True):
    n = len(params)
    for i in range(n):
        layer = params[str(i)]
        x = x @ layer["w"] + layer["b"]
        if i < n - 1 or not final_linear:
            x = torch.tanh(x)
    return x


def init_sac_params(generator: torch.Generator, obs_dim: int,
                    action_dim: int, hidden=(64, 64),
                    initial_alpha: float = 0.1, device=None) -> dict:
    """The reference's tree: actor, twin critics, a 0-d ``log_alpha``."""
    device = resolve_device(device)
    return {
        "actor": _mlp_init(generator, (obs_dim, *hidden, 2 * action_dim),
                           device),
        "q1": _mlp_init(generator, (obs_dim + action_dim, *hidden, 1), device),
        "q2": _mlp_init(generator, (obs_dim + action_dim, *hidden, 1), device),
        "log_alpha": torch.tensor(float(np.log(initial_alpha)),
                                  dtype=torch.float32, device=device),
    }


def _gaussian(generator: torch.Generator, shape, like: torch.Tensor):
    """Standard normal draws of `shape` from `generator`, on `like`'s
    device and dtype."""
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=like.dtype).to(like.device)


def actor_sample(actor_params, obs, generator=None, action_scale: float = 1.0,
                 noise=None):
    """Tanh-squashed Gaussian: returns (action * scale, log_prob). The tanh
    log-det-Jacobian correction uses the numerically-stable softplus
    form: log(1 - tanh(u)^2) = 2 (log 2 - u - softplus(-2u)). `noise`
    (standard normal, the mean's shape or with leading sample dims) takes
    the place of a draw from `generator`."""
    out = _mlp(actor_params, obs)
    mu, log_std = out.chunk(2, dim=-1)
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    std = torch.exp(log_std)
    if noise is None:
        noise = _gaussian(generator, mu.shape, mu)
    u = mu + std * noise
    logp_u = torch.sum(-0.5 * ((u - mu) / std) ** 2 - log_std
                       - _HALF_LOG_2PI, dim=-1)
    a = torch.tanh(u)
    logp = logp_u - torch.sum(
        2.0 * (_LOG_2 - u - torch.nn.functional.softplus(-2.0 * u)), dim=-1)
    return a * action_scale, logp


def actor_mean(actor_params, obs, action_scale: float):
    mu, _ = _mlp(actor_params, obs).chunk(2, dim=-1)
    return torch.tanh(mu) * action_scale


def q_value(q_params, obs, action):
    """Q over the last axis of [obs, action]; leading dims broadcast."""
    return _mlp(q_params, torch.cat([obs, action], dim=-1))[..., 0]


def _to_tensor(leaf, device, path: str) -> torch.Tensor:
    if isinstance(leaf, dict):
        raise ValueError(f"param tree at {path} is a subtree, expected a "
                         f"leaf")
    return rl_module._to_tensor(leaf).to(device)


def _convert_mlp(tree, device, path: str, width_in=None, width_out=None):
    """A numpy-leaf MLP subtree {'0': {w, b}, ...} → tensors, with the
    layers chained from `width_in` to `width_out` (None: not checked)."""
    if not isinstance(tree, dict) or not tree or set(tree) != {
            str(i) for i in range(len(tree))}:
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"param tree at {path} must hold layers "
                         f"'0'..'n-1', got {got}")
    out = {}
    prev = width_in
    for i in range(len(tree)):
        layer, where = tree[str(i)], f"{path}/{i}"
        if not isinstance(layer, dict) or set(layer) != {"w", "b"}:
            got = sorted(layer) if isinstance(layer, dict) else layer
            raise ValueError(f"param tree at {where} has keys {got}, "
                             f"expected ['b', 'w']")
        w = _to_tensor(layer["w"], device, f"{where}/w")
        b = _to_tensor(layer["b"], device, f"{where}/b")
        last = i == len(tree) - 1
        if w.dim() != 2 or (prev is not None and w.shape[0] != prev) or (
                last and width_out is not None and w.shape[1] != width_out):
            raise ValueError(
                f"param {where}/w has shape {tuple(w.shape)}, expected "
                f"[{prev if prev is not None else 'in'}, "
                f"{width_out if last and width_out is not None else 'out'}]")
        if tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"param {where}/b has shape {tuple(b.shape)}, "
                             f"expected ({w.shape[1]},)")
        out[str(i)] = {"w": w, "b": b}
        prev = w.shape[1]
    return out


def _check_keys(tree, keys, path: str) -> None:
    if not isinstance(tree, dict) or set(tree) != set(keys):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"param tree at {path} has keys {got}, expected "
                         f"{sorted(keys)}")


def params_from_jax(tree, device=None) -> dict:
    """The JAX package's numpy-leaf SAC tree {actor, q1, q2, log_alpha}
    (also CQL's) or IQL's {q1, q2, actor: {net, log_std}, v} → the port's
    tensors on `device` (None: the card). Keys and shapes are checked: the
    critics read [obs, action] and give one value, SAC's actor gives a mean
    and a log-std per action dimension, ``log_alpha`` is 0-d."""
    device = resolve_device(device)
    if isinstance(tree, dict) and "v" in tree:  # IQL
        _check_keys(tree, ("q1", "q2", "actor", "v"), "<root>")
        _check_keys(tree["actor"], ("net", "log_std"), "actor")
        net = _convert_mlp(tree["actor"]["net"], device, "actor/net")
        obs_dim = net["0"]["w"].shape[0]
        act_dim = net[str(len(net) - 1)]["w"].shape[1]
        log_std = _to_tensor(tree["actor"]["log_std"], device,
                             "actor/log_std")
        if tuple(log_std.shape) != (act_dim,):
            raise ValueError(f"param actor/log_std has shape "
                             f"{tuple(log_std.shape)}, expected ({act_dim},)")
        out = {"actor": {"net": net, "log_std": log_std},
               "v": _convert_mlp(tree["v"], device, "v", obs_dim, 1)}
    else:
        _check_keys(tree, ("actor", "q1", "q2", "log_alpha"), "<root>")
        actor = _convert_mlp(tree["actor"], device, "actor")
        obs_dim = actor["0"]["w"].shape[0]
        width = actor[str(len(actor) - 1)]["w"].shape[1]
        if width % 2:
            raise ValueError(f"param actor/{len(actor) - 1}/w gives {width} "
                             f"outputs, expected a mean and a log-std each")
        act_dim = width // 2
        log_alpha = _to_tensor(tree["log_alpha"], device, "log_alpha")
        if log_alpha.dim() != 0:
            raise ValueError(f"param log_alpha has shape "
                             f"{tuple(log_alpha.shape)}, expected ()")
        out = {"actor": actor, "log_alpha": log_alpha}
    for q in ("q1", "q2"):
        out[q] = _convert_mlp(tree[q], device, q, obs_dim + act_dim, 1)
    return out


# --------------------------------------------------------------- env runner


@ray_tpu_torch.remote(num_cpus=RUNNER_NUM_CPUS, num_gpus=0)
class _SACRunner:
    """Remote rollout actor: samples stochastic actions from the current
    actor network (a CPU copy, one torch thread, a seeded generator) and
    returns transitions."""

    def __init__(self, env_id, num_envs: int, seed: int = 0,
                 action_scale: float = 1.0):
        self.gen = _runner_torch(seed)
        self.env = make_vec_env(env_id, num_envs, seed)
        self.obs = self.env.reset(seed)
        self.action_scale = action_scale

    def sample(self, actor_blob: bytes, num_steps: int,
               random_actions: bool = False) -> dict:
        from ray_tpu_torch._private import serialization as ser

        actor = None if random_actions else _convert_mlp(
            ser.loads(actor_blob), "cpu", "actor")
        N = self.env.num_envs
        obs_l, act_l, rew_l, next_l, done_l = [], [], [], [], []
        for _ in range(num_steps):
            if random_actions:
                a = ((torch.rand((N, self.env.action_dim), generator=self.gen)
                      * 2.0 - 1.0) * self.action_scale).numpy()
            else:
                with torch.no_grad():
                    a, _ = actor_sample(actor, torch.as_tensor(
                        self.obs, dtype=torch.float32), self.gen,
                        self.action_scale)
                a = a.numpy()
            nxt, r, d, info = self.env.step(a)
            obs_l.append(self.obs)
            act_l.append(a)
            rew_l.append(r)
            # time-limit truncations are NOT terminals: bootstrap through
            # them from the pre-reset final observation
            truncated = info.get("truncated")
            if truncated is not None and truncated.any():
                stored_next = nxt.copy()
                stored_next[truncated] = info["final_obs"][truncated]
                next_l.append(stored_next)
                done_l.append(d & ~truncated)
            else:
                next_l.append(nxt)
                done_l.append(d)
            self.obs = nxt
        return {
            "obs": np.concatenate(obs_l, 0),
            "actions": np.concatenate(act_l, 0),
            "rewards": np.concatenate(rew_l, 0),
            "next_obs": np.concatenate(next_l, 0),
            "dones": np.concatenate(done_l, 0),
            "episode_returns": self.env.drain_episode_returns(),
        }

    def ping(self) -> bool:
        """Readiness probe, as EnvRunner's."""
        return True


# ------------------------------------------------------------------ learner


def _step(optimizer: torch.optim.Optimizer, loss, leaves: list) -> None:
    """One step of `optimizer` on d loss / d `leaves` only: no gradient
    reaches or accumulates into any other tensor the loss read."""
    for t, g in zip(leaves, torch.autograd.grad(loss, leaves)):
        t.grad = g
    optimizer.step()


def sac_optimizers(params: dict, lr: float,
                   third: str = "log_alpha") -> dict:
    """Three Adams, as the reference's three optax.adam states: the actor,
    the twin critics together, and `third` (SAC's ``log_alpha``, IQL's
    ``v``)."""
    out = {}
    for name, sub in (("actor", params["actor"]),
                      ("q", {"q1": params["q1"], "q2": params["q2"]}),
                      (third, params[third])):
        out[name] = learner_mod.make_optimizer(sub, lr) if isinstance(
            sub, dict) else torch.optim.Adam(
            [sub.requires_grad_(True)], lr=lr)
    return out


def polyak_(target: dict, online: dict, tau: float) -> None:
    """target ← (1 - tau) target + tau online, in place, untracked."""
    with torch.no_grad():
        t, o = learner_mod.leaves(target), learner_mod.leaves(online)
        torch._foreach_mul_(t, 1.0 - tau)
        torch._foreach_add_(t, o, alpha=tau)


def soft_target(params, target_q, batch, *, gamma, action_scale, generator,
                noise):
    """r + gamma (1 - done) (min target-Q - alpha log pi) at the next
    observation, from the pre-update actor and temperature; untracked."""
    with torch.no_grad():
        a_next, logp_next = actor_sample(params["actor"], batch["next_obs"],
                                         generator, action_scale, noise)
        tq1 = q_value(target_q["q1"], batch["next_obs"], a_next)
        tq2 = q_value(target_q["q2"], batch["next_obs"], a_next)
        alpha = torch.exp(params["log_alpha"])
        soft_q = torch.minimum(tq1, tq2) - alpha * logp_next
        nonterminal = 1.0 - batch["dones"].to(torch.float32)
        return batch["rewards"] + gamma * nonterminal * soft_q


def actor_and_alpha_steps(params, optimizers, batch, q_loss, q_mean, *,
                          action_scale, target_entropy, autotune, generator,
                          noise) -> dict:
    """SAC's actor step against the fresh critics (gradients to the
    actor's leaves only, alpha detached), then the temperature step from
    that step's log-probs; returns the metrics as device tensors."""
    a, logp = actor_sample(params["actor"], batch["obs"], generator,
                           action_scale, noise)
    q1 = q_value(params["q1"], batch["obs"], a)
    q2 = q_value(params["q2"], batch["obs"], a)
    alpha = torch.exp(params["log_alpha"]).detach()
    pi_loss = torch.mean(alpha * logp - torch.minimum(q1, q2))
    _step(optimizers["actor"], pi_loss,
          learner_mod.leaves(params["actor"]))
    logp = logp.detach()
    if autotune:
        a_loss = -torch.mean(torch.exp(params["log_alpha"])
                             * (logp + target_entropy))
        _step(optimizers["log_alpha"], a_loss, [params["log_alpha"]])
        a_loss = a_loss.detach()
    else:
        a_loss = torch.zeros((), device=logp.device)
    return {"q_loss": q_loss.detach(), "pi_loss": pi_loss.detach(),
            "alpha_loss": a_loss,
            "alpha": torch.exp(params["log_alpha"].detach()),
            "q_mean": q_mean, "entropy": -torch.mean(logp)}


def make_sac_update(optimizers: dict, *, gamma: float, tau: float,
                    action_scale: float, target_entropy: float,
                    autotune: bool):
    """-> update(params, target_q, batch, generator=None, noise=None) →
    metrics: one SAC step in the reference's order, in place: the critics
    against the soft target, the actor against the fresh critics, the
    temperature, then polyak. `noise` {"next": [B, d], "pi": [B, d]} takes
    the place of the two Gaussian draws from `generator`. The metrics stay
    device tensors (``learner.floats`` reads them)."""

    def update(params, target_q, batch, generator=None, noise=None):
        noise = noise or {}
        target = soft_target(params, target_q, batch, gamma=gamma,
                             action_scale=action_scale, generator=generator,
                             noise=noise.get("next"))
        q1 = q_value(params["q1"], batch["obs"], batch["actions"])
        q2 = q_value(params["q2"], batch["obs"], batch["actions"])
        q_loss = torch.mean((q1 - target) ** 2) + torch.mean((q2 - target) ** 2)
        _step(optimizers["q"], q_loss, learner_mod.leaves(
            {"q1": params["q1"], "q2": params["q2"]}))
        metrics = actor_and_alpha_steps(
            params, optimizers, batch, q_loss, torch.mean(q1.detach()),
            action_scale=action_scale, target_entropy=target_entropy,
            autotune=autotune, generator=generator, noise=noise.get("pi"))
        polyak_(target_q, {"q1": params["q1"], "q2": params["q2"]}, tau)
        return metrics

    return update


class SAC(Algorithm):
    def _setup(self):
        cfg = self.config
        probe = make_vec_env(cfg.env_id, 1, cfg.seed)
        if getattr(probe, "action_dim", 0) < 1:
            raise ValueError(
                f"SAC needs a continuous-action env; {cfg.env_id!r} has no "
                "action_dim (use DQN/PPO/IMPALA/APPO for discrete actions)")
        self.obs_dim = probe.obs_dim
        self.action_dim = probe.action_dim
        self.action_scale = float(getattr(probe, "action_high", 1.0))
        self.target_entropy = (cfg.target_entropy
                               if cfg.target_entropy is not None
                               else -float(self.action_dim))
        # drawn on the CPU, so a seed gives the same init on every device
        self.params = init_sac_params(
            torch.Generator().manual_seed(cfg.seed), self.obs_dim,
            self.action_dim, hidden=cfg.model_hidden,
            initial_alpha=cfg.initial_alpha, device=self.device)
        self.target_q = snapshot({"q1": self.params["q1"],
                                  "q2": self.params["q2"]})
        self._make_optimizers()
        # replay over continuous actions
        self.buffer = ReplayBuffer(cfg.buffer_size, self.obs_dim,
                                   seed=cfg.seed,
                                   action_dim=self.action_dim)
        self.runners = [
            _SACRunner.remote(cfg.env_id, cfg.num_envs_per_runner,
                              cfg.seed + 1000 * (i + 1),
                              action_scale=self.action_scale)
            for i in range(cfg.num_env_runners)]
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 7)
        self._env_steps = 0
        self._num_updates = 0

    def _make_optimizers(self):
        cfg = self.config
        self.optimizers = sac_optimizers(self.params, cfg.lr)
        self._update = make_sac_update(
            self.optimizers, gamma=cfg.gamma, tau=cfg.tau,
            action_scale=self.action_scale,
            target_entropy=self.target_entropy, autotune=cfg.autotune_alpha)

    def training_step(self) -> dict:
        cfg = self.config
        from ray_tpu_torch._private import serialization as ser

        blob = ser.dumps(rl_module.to_numpy(self.params["actor"]))
        warmup = self._env_steps < cfg.learning_starts
        refs = [r.sample.remote(blob, cfg.rollout_fragment_length,
                                random_actions=warmup)
                for r in self.runners]
        for s in ray_tpu_torch.get(refs, timeout=300):
            self.buffer.add_batch(s["obs"], s["actions"], s["rewards"],
                                  s["next_obs"], s["dones"])
            self._env_steps += len(s["rewards"])
            self._episode_returns.extend(s["episode_returns"])
        metrics: dict = {"env_steps": self._env_steps,
                         "buffer_size": len(self.buffer)}
        if len(self.buffer) < cfg.learning_starts:
            return metrics
        m: dict = {}
        for _ in range(cfg.num_updates_per_step):
            batch = learner_mod.batch_to(
                self.buffer.sample(cfg.train_batch_size), self.device)
            m = self._update(self.params, self.target_q, batch,
                             self.generator)
            self._num_updates += 1
        metrics.update(learner_mod.floats(m))
        metrics["num_updates"] = self._num_updates
        return metrics

    def compute_single_action(self, obs) -> np.ndarray:
        """Deterministic (mean) action for evaluation."""
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(obs, np.float32),
                                device=self.device)[None]
            return actor_mean(self.params["actor"], x,
                              self.action_scale)[0].cpu().numpy()

    def save(self, path: str) -> str:
        from ray_tpu_torch.llm import checkpoint_io

        os.makedirs(path, exist_ok=True)
        checkpoint_io.save_params(self.params, os.path.join(path, "module"))
        return path

    def restore(self, path: str) -> None:
        from ray_tpu_torch.llm import checkpoint_io

        _merge(self.params, checkpoint_io.load_params(
            os.path.join(path, "module")))
        self.target_q = snapshot({"q1": self.params["q1"],
                                  "q2": self.params["q2"]})
        self._make_optimizers()  # fresh Adam states, as the reference's init

    def stop(self):
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self.runners.clear()


SACConfig.algo_class = SAC
