"""MARWIL — monotonic advantage re-weighted imitation learning.

(reference: rllib/algorithms/marwil/ — MARWILConfig/MARWIL trains from
logged episodes by exponentially advantage-weighted behavior cloning plus
a value-function baseline; Wang et al. 2018. beta=0 degenerates to plain
BC. Offline like BC: the data source is a ray_tpu_torch.data Dataset or
an in-memory list of {obs, action, reward, done} rows in episode order.)
The data, the params, the Adam state and the advantage normaliser live on
the learner's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib import learner as learner_mod
from ray_tpu_torch.rllib import rl_module
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.bc import _nll_and_accuracy, rows_of


class MARWILConfig(AlgorithmConfig):
    algo_class = None  # set below

    def __init__(self):
        super().__init__()
        self.offline_data = None       # Dataset | list of rows, episode order
        self.obs_dim = None
        self.num_actions = None
        self.train_batch_size = 256
        self.beta = 1.0                # 0 => plain BC
        self.vf_coeff = 1.0
        self.moving_average_sqd_adv_norm_update_rate = 1e-2

    def offline(self, *, offline_data=None, obs_dim=None, num_actions=None,
                train_batch_size=None, beta=None, vf_coeff=None,
                **_ignored) -> "MARWILConfig":
        for name, val in (("offline_data", offline_data),
                          ("obs_dim", obs_dim),
                          ("num_actions", num_actions),
                          ("train_batch_size", train_batch_size),
                          ("beta", beta), ("vf_coeff", vf_coeff)):
            if val is not None:
                setattr(self, name, val)
        return self


def make_marwil_update(optimizer: torch.optim.Optimizer, *, beta: float,
                       vf_coeff: float, ma_rate: float):
    """-> update(params, ma_sqd_adv, batch) → (ma_sqd_adv, metrics): one
    Adam step of `optimizer` on the advantage-weighted NLL plus the value
    loss; `ma_sqd_adv` (a 0-d tensor on the params' device) is the moving
    average of the squared advantage, read and renewed outside the
    gradient."""

    def update(params, ma_sqd_adv, batch):
        logits, value = rl_module.forward(params, batch["obs"])
        adv = batch["returns"] - value
        vf_loss = torch.mean(adv ** 2)
        adv_d = adv.detach()
        # advantage scale tracked as a moving average OUTSIDE the gradient
        # (paper's c normalizer), so exp() stays bounded
        scale = torch.sqrt(ma_sqd_adv.detach()) + 1e-8
        # cap the exp weight (paper's numerical guard; RLlib clips the
        # exponent) so a few large advantages can't dominate the batch
        if beta:
            weights = torch.clamp(torch.exp(torch.clamp(
                beta * adv_d / scale, -20.0, 20.0)), max=20.0)
        else:
            weights = torch.ones_like(adv_d)
        nll, acc = _nll_and_accuracy(logits, batch["actions"])
        pi_loss = torch.mean(weights * nll)
        loss = pi_loss + vf_coeff * vf_loss
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        ma_sqd_adv = ((1 - ma_rate) * ma_sqd_adv.detach()
                      + ma_rate * torch.mean(adv_d ** 2))
        return ma_sqd_adv, {"policy_loss": pi_loss.detach(),
                            "vf_loss": vf_loss.detach(),
                            "imitation_accuracy": acc,
                            "mean_weight": torch.mean(weights),
                            "total_loss": loss.detach()}

    return update


def _returns_to_go(rewards: np.ndarray, dones: np.ndarray,
                   gamma: float) -> np.ndarray:
    """Discounted return-to-go per timestep, resetting at episode ends."""
    out = np.zeros_like(rewards, dtype=np.float64)
    acc = 0.0
    for i in range(len(rewards) - 1, -1, -1):
        if dones[i]:
            acc = 0.0
        acc = rewards[i] + gamma * acc
        out[i] = acc
    return out.astype(np.float32)


class MARWIL(Algorithm):
    def _setup(self):
        cfg = self.config
        if cfg.offline_data is None or cfg.obs_dim is None or cfg.num_actions is None:
            raise ValueError(
                "MARWIL needs .offline(offline_data=..., obs_dim=..., "
                "num_actions=...)")
        obs, acts, rews, dones = [], [], [], []
        for row in rows_of(cfg.offline_data):
            obs.append(np.asarray(row["obs"], np.float32))
            acts.append(int(row["action"]))
            rews.append(float(row.get("reward", 0.0)))
            dones.append(bool(row.get("done", False)))
        returns = _returns_to_go(
            np.asarray(rews, np.float32), np.asarray(dones, bool), cfg.gamma)
        self._n = len(acts)
        # the whole dataset on the learner's device once
        self._data = learner_mod.batch_to(
            {"obs": np.stack(obs), "actions": np.asarray(acts, np.int32),
             "returns": returns}, self.device)
        # drawn on the CPU, so a seed gives the same init on every device
        self.params = rl_module.init(torch.Generator().manual_seed(cfg.seed),
                                     cfg.obs_dim, cfg.num_actions,
                                     cfg.model_hidden, device=self.device)
        self.optimizer = learner_mod.make_optimizer(self.params, cfg.lr)
        # start the advantage normalizer at the data's return scale (V≈0 at
        # init, so adv≈returns): starting at 1.0 makes the first hundreds of
        # exp-weights astronomically hot and destabilizes the policy before
        # the moving average can catch up
        self.ma_sqd_adv = torch.tensor(
            max(float(np.mean(returns ** 2)), 1e-6), dtype=torch.float32,
            device=self.device)
        self._update = make_marwil_update(
            self.optimizer, beta=cfg.beta, vf_coeff=cfg.vf_coeff,
            ma_rate=cfg.moving_average_sqd_adv_norm_update_rate)
        self._rng = np.random.default_rng(cfg.seed)

    def training_step(self) -> dict:
        cfg = self.config
        order = torch.as_tensor(self._rng.permutation(self._n),
                                device=self.device)
        last = None
        trained = 0
        for lo in range(0, self._n, cfg.train_batch_size):
            sel = order[lo:lo + cfg.train_batch_size]
            self.ma_sqd_adv, last = self._update(
                self.params, self.ma_sqd_adv,
                {k: v[sel] for k, v in self._data.items()})
            trained += int(sel.shape[0])
        # one host copy, after the loop
        metrics = learner_mod.floats(last) if last else {}
        metrics["num_samples_trained"] = trained
        return metrics

    def predict(self, obs) -> np.ndarray:
        return rl_module.forward_inference(self.params, np.asarray(
            obs, np.float32)).cpu().numpy().astype(np.int32)


MARWILConfig.algo_class = MARWIL
