"""IMPALA: asynchronous actor-learner RL with V-trace off-policy correction.

(reference: rllib/algorithms/impala/ — decoupled rollout actors STREAM
trajectory batches (num_returns="streaming" generators with backpressure)
under whatever weights they last received; the learner consumes batches as
they arrive, corrects the off-policy gap with V-trace, updates, and pushes
fresh weights back asynchronously; Espeholt et al. 2018.)

V-trace targets (vs) and the policy-gradient advantage:
  rho_t = min(rho_bar, pi(a|s)/mu(a|s)),  c_t = min(c_bar, pi/mu)
  delta_t = rho_t (r_t + gamma V(x_{t+1}) - V(x_t))
  vs_t = V_t + delta_t + gamma c_t (vs_{t+1} - V_{t+1})
  adv_t = rho_t (r_t + gamma vs_{t+1} - V_t)

The learner's params and Adam state live on its device (the card unless the
caller asks for the CPU); the runners are CPU actors (env_runner.py).
"""

from __future__ import annotations

import torch

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib import learner as learner_mod
from ray_tpu_torch.rllib import rl_module
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import snapshot
from ray_tpu_torch.rllib.env import make_vec_env
from ray_tpu_torch.rllib.env_runner import EnvRunner

# optax.clip_by_global_norm's bound in the reference's optimizer chain
MAX_GRAD_NORM = 40.0
# batches a runner's stream may hold ahead of the learner (the runtime's
# default is 16). Two CPU runners make batches faster than the card's
# launch-bound learner takes them, so at 16 the learner trains on batches
# up to 16 of its updates stale, and late policy collapses failed the
# reference test's bar on the card (tests/rllib_impala_repeats.py); at 2
# the data stays about as fresh as for the reference's jitted learner
STREAM_AHEAD = 2
_BATCH_KEYS = ("obs", "actions", "behavior_logp", "rewards", "dones",
               "bootstrap_obs")


class IMPALAConfig(AlgorithmConfig):
    algo_class = None  # set below

    def __init__(self):
        super().__init__()
        self.rho_bar = 1.0
        self.c_bar = 1.0
        self.batches_per_iteration = 8


@torch.no_grad()
def _vtrace(target_logp, behavior_logp, rewards, values, dones, last_value,
            *, gamma, rho_bar, c_bar):
    """All inputs time-major [T, N] (last_value [N]); returns (vs [T, N],
    pg_adv [T, N]), detached: the reference stops their gradient. The
    reverse scan is a loop over T on the inputs' device."""
    ratio = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(ratio, max=rho_bar)
    c = torch.clamp(ratio, max=c_bar)
    not_done = 1.0 - dones.to(torch.float32)
    v_next = torch.cat([values[1:], last_value[None]], dim=0) * not_done
    delta = rho * (rewards + gamma * v_next - values)
    decay = gamma * c * not_done
    acc = torch.zeros_like(delta[0])  # vs_{t+1} - V_{t+1}
    adv = torch.empty_like(delta)
    for t in range(delta.shape[0] - 1, -1, -1):
        acc = delta[t] + decay[t] * acc
        adv[t] = acc
    vs = values + adv
    vs_next = torch.cat([vs[1:], last_value[None]], dim=0) * not_done
    pg_adv = rho * (rewards + gamma * vs_next - values)
    return vs, pg_adv


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm's rule, in place: every gradient times
    max_norm / ||g|| when ||g|| >= max_norm, untouched below it, with no
    epsilon (torch.nn.utils.clip_grad_norm_ divides by ||g|| + 1e-6).
    No host sync: the scale is a device tensor. Returns ||g||."""
    g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(g_norm < max_norm, torch.ones_like(g_norm),
                        max_norm / g_norm)
    torch._foreach_mul_(grads, scale)
    return g_norm


class ImpalaLearner:
    """V-trace actor-critic update over time-major batches, on the
    learner's device. The loss is a pluggable method (`_loss`): APPO reuses
    the init/optimizer/update/weights plumbing here and overrides only the
    surrogate and the target refresh (appo.py)."""

    def __init__(self, obs_dim: int, num_actions: int, *, lr: float = 5e-4,
                 hidden=(64, 64), vf_coef: float = 0.5, ent_coef: float = 0.01,
                 gamma: float = 0.99, rho_bar: float = 1.0, c_bar: float = 1.0,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.gamma, self.rho_bar, self.c_bar = gamma, rho_bar, c_bar
        self.vf_coef, self.ent_coef = vf_coef, ent_coef
        # drawn on the CPU, so a seed gives the same init on every device
        self.params = rl_module.init(torch.Generator().manual_seed(seed),
                                     obs_dim, num_actions, tuple(hidden),
                                     device=self.device)
        # target/anchor params: unused by IMPALA's loss, refreshed by APPO.
        # A detached clone: the optimizer updates the live leaves in place
        self.target_params = snapshot(self.params)
        self.optimizer = learner_mod.make_optimizer(self.params, lr)
        self.version = 0

    def _policy_terms(self, p, batch):
        """Shared forward pass + V-trace targets. Returns
        (target_logp, logp_all, values, vs, pg_adv), all time-major."""
        T, N = batch["rewards"].shape
        logits, values = rl_module.forward(p, batch["obs"].reshape(T * N, -1))
        logp_all = torch.log_softmax(logits, dim=-1)
        target_logp = logp_all.gather(
            1, batch["actions"].reshape(T * N, 1).long())[:, 0].reshape(T, N)
        values = values.reshape(T, N)
        with torch.no_grad():  # reaches only the stopped V-trace targets
            _, last_value = rl_module.forward(p, batch["bootstrap_obs"])
        vs, pg_adv = _vtrace(
            target_logp, batch["behavior_logp"], batch["rewards"], values,
            batch["dones"], last_value, gamma=self.gamma,
            rho_bar=self.rho_bar, c_bar=self.c_bar)
        return target_logp, logp_all, values, vs, pg_adv

    def _loss(self, p, target_params, batch):
        target_logp, logp_all, values, vs, pg_adv = self._policy_terms(
            p, batch)
        pg_loss = -torch.mean(target_logp * pg_adv)
        vf_loss = 0.5 * torch.mean((vs - values) ** 2)
        ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        loss = pg_loss + self.vf_coef * vf_loss - self.ent_coef * ent
        return loss, {"pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": ent}

    def _post_update(self):
        """Hook: APPO refreshes its target network here."""

    def update(self, batch: dict) -> dict:
        """One clipped Adam step on a runner's time-major batch (numpy or
        tensors), moved to the learner's device once."""
        tb = learner_mod.batch_to({k: batch[k] for k in _BATCH_KEYS},
                                  self.device)
        loss, aux = self._loss(self.params, self.target_params, tb)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_global_norm_([t.grad for t in learner_mod.leaves(
            self.params)], MAX_GRAD_NORM)
        self.optimizer.step()
        self.version += 1
        self._post_update()
        vals = learner_mod.floats({"loss": loss.detach(),
                                   **{k: v.detach() for k, v in aux.items()}})
        out = {"loss": vals.pop("loss"), "weights_version": self.version}
        out.update(vals)
        return out

    def get_weights_blob(self) -> bytes:
        from ray_tpu_torch._private import serialization as ser

        return ser.dumps(rl_module.to_numpy(self.params))


class IMPALA(Algorithm):
    def _setup(self):
        cfg = self.config
        probe = make_vec_env(cfg.env_id, 1, cfg.seed)
        self.learner = ImpalaLearner(
            probe.obs_dim, probe.num_actions, lr=cfg.lr,
            hidden=cfg.model_hidden, vf_coef=cfg.vf_loss_coeff,
            ent_coef=cfg.entropy_coeff, gamma=cfg.gamma,
            rho_bar=getattr(cfg, "rho_bar", 1.0),
            c_bar=getattr(cfg, "c_bar", 1.0), seed=cfg.seed,
            device=self.device)
        self._start_runners()

    def _start_runners(self):
        self._streams: list = []
        self._runners: list = []
        for i in range(self.config.num_env_runners):
            self._start_runner(i)

    def _start_runner(self, seed_offset: int):
        cfg = self.config
        runner = EnvRunner.options(max_concurrency=2).remote(
            cfg.env_id, cfg.num_envs_per_runner,
            cfg.seed + 1000 * (seed_offset + 1))
        runner.set_weights.remote(self.learner.get_weights_blob())
        stream = runner.stream_rollouts.options(
            num_returns="streaming",
            _generator_backpressure_num_objects=STREAM_AHEAD).remote(
            cfg.rollout_fragment_length)
        self._runners.append(runner)
        self._streams.append(stream)

    def training_step(self) -> dict:
        cfg = self.config
        out: dict = {}
        consumed = 0
        idx = 0
        while consumed < cfg.batches_per_iteration and self._streams:
            i = idx % len(self._streams)
            idx += 1
            try:
                # bounded wait: a HUNG runner (alive but stuck) must also
                # trip the restart path, not block for a day
                ref = self._streams[i].next_item(timeout=120.0)
                batch = ray_tpu_torch.get(ref, timeout=120.0)
            except StopIteration:
                # stream exhausted (bounded runs): restart it
                self._restart(i)
                continue
            except Exception:
                # runner died mid-iteration (reference: FaultAwareApply
                # restarts failed env runners): replace it and keep going
                self._restart(i)
                continue
            self._episode_returns.extend(batch.pop("episode_returns", ()))
            out = self.learner.update(batch)
            consumed += 1
            # async weight push: the runner picks it up for its NEXT batch;
            # no barrier — staleness is what V-trace corrects
            try:
                self._runners[i].set_weights.remote(
                    self.learner.get_weights_blob())
            except Exception:
                self._restart(i)
        out["batches_consumed"] = consumed
        out["num_healthy_runners"] = len(self._runners)
        return out

    def _restart(self, i: int):
        try:
            ray_tpu_torch.kill(self._runners[i])
        except Exception:
            pass
        self._runners.pop(i)
        self._streams.pop(i)
        self._start_runner(len(self._runners)
                           + int(self.rng.integers(100, 10_000)))

    def stop(self):
        for r in self._runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self._runners.clear()
        self._streams.clear()


IMPALAConfig.algo_class = IMPALA
