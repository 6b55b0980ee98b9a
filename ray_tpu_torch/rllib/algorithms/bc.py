"""BC — behavior cloning: offline RL on a ray_tpu_torch.data Dataset.

(reference: rllib/algorithms/bc/ + the offline-RL pipeline on Ray Data,
rllib/offline/ — trains a policy by supervised imitation of logged
(obs, action) pairs streamed from a dataset.) The params and Adam state
live on the learner's device; each batch is sent there once.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch.rllib import learner as learner_mod
from ray_tpu_torch.rllib import rl_module
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig


class BCConfig(AlgorithmConfig):
    algo_class = None  # set below

    def __init__(self):
        super().__init__()
        self.offline_data = None       # ray_tpu_torch.data Dataset | list[dict]
        self.obs_dim = None            # required (no env probe offline)
        self.num_actions = None
        self.train_batch_size = 256

    def offline(self, *, offline_data=None, obs_dim=None, num_actions=None,
                train_batch_size=None, **_ignored) -> "BCConfig":
        if offline_data is not None:
            self.offline_data = offline_data
        if obs_dim is not None:
            self.obs_dim = obs_dim
        if num_actions is not None:
            self.num_actions = num_actions
        if train_batch_size is not None:
            self.train_batch_size = train_batch_size
        return self


def _nll_and_accuracy(logits, actions):
    """Per-row negative log-likelihood of the data actions, and the share
    of rows whose greedy action is the data's."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, actions.long()[:, None])[:, 0]
    acc = torch.mean((torch.argmax(logits, dim=-1) == actions.long())
                     .to(torch.float32))
    return nll, acc


def make_bc_update(optimizer: torch.optim.Optimizer):
    """-> update(params, batch) → metrics: one Adam step of `optimizer`
    (whose leaves are `params`') on the imitation NLL; metrics as device
    tensors."""

    def update(params, batch):
        logits, _ = rl_module.forward(params, batch["obs"])
        nll, acc = _nll_and_accuracy(logits, batch["actions"])
        loss = torch.mean(nll)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return {"imitation_accuracy": acc, "total_loss": loss.detach()}

    return update


def rows_of(data):
    """A Dataset's rows (``iter_rows``) or an in-memory list's."""
    return data.iter_rows() if hasattr(data, "iter_rows") else iter(data)


class BC(Algorithm):
    def _setup(self):
        cfg = self.config
        if cfg.offline_data is None or cfg.obs_dim is None or cfg.num_actions is None:
            raise ValueError(
                "BC needs .offline(offline_data=..., obs_dim=..., "
                "num_actions=...)")
        # drawn on the CPU, so a seed gives the same init on every device
        self.params = rl_module.init(torch.Generator().manual_seed(cfg.seed),
                                     cfg.obs_dim, cfg.num_actions,
                                     cfg.model_hidden, device=self.device)
        self.optimizer = learner_mod.make_optimizer(self.params, cfg.lr)
        self._update = make_bc_update(self.optimizer)

    def _batches(self):
        """Stream (obs, actions) batches from the configured source: a
        ray_tpu_torch.data Dataset of {'obs': ..., 'action': ...} rows, or
        an in-memory list of such dicts; each on the learner's device."""
        bs = self.config.train_batch_size
        obs, acts = [], []

        def batch():
            return learner_mod.batch_to(
                {"obs": np.stack(obs),
                 "actions": np.asarray(acts, np.int32)}, self.device)

        for row in rows_of(self.config.offline_data):
            obs.append(np.asarray(row["obs"], np.float32))
            acts.append(int(row["action"]))
            if len(obs) >= bs:
                yield batch()
                obs, acts = [], []
        if obs:
            yield batch()

    def training_step(self) -> dict:
        m: dict = {}
        n = 0
        for batch in self._batches():
            m = self._update(self.params, batch)
            n += int(batch["actions"].shape[0])
        metrics = learner_mod.floats(m)
        metrics["num_samples_trained"] = n
        return metrics

    def predict(self, obs) -> np.ndarray:
        return rl_module.forward_inference(self.params, np.asarray(
            obs, np.float32)).cpu().numpy().astype(np.int32)


BCConfig.algo_class = BC
