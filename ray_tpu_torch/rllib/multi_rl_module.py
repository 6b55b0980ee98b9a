"""MultiRLModule: a ModuleID -> policy-params mapping.

(reference: rllib/core/rl_module/multi_rl_module.py:48 — MultiRLModule
holds n sub-RLModules keyed by ModuleID; which module serves which agent
is the CALLER's policy-mapping decision, not the module's. Here each
sub-module is the same functional (init, forward) pair as rl_module.py, so
the whole thing is a dict of params dicts: per-policy learners update
independently, and a shared policy is the same params serving every
mapped agent.)
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tpu_torch.rllib import rl_module


@dataclasses.dataclass(frozen=True)
class RLModuleSpec:
    """Per-policy network spec (reference: core/rl_module/rl_module.py
    RLModuleSpec — obs/action spaces + model config)."""

    obs_dim: int
    num_actions: int
    hidden: tuple = (64, 64)


@dataclasses.dataclass(frozen=True)
class MultiRLModuleSpec:
    """(reference: multi_rl_module.py MultiRLModuleSpec — dict of
    ModuleID -> RLModuleSpec.)"""

    module_specs: dict  # ModuleID -> RLModuleSpec

    def keys(self):
        return self.module_specs.keys()

    def __getitem__(self, module_id: str) -> RLModuleSpec:
        return self.module_specs[module_id]


def init_multi(generator: torch.Generator, spec: MultiRLModuleSpec,
               device=None) -> dict:
    """-> {module_id: params}; independent init per policy, the modules
    drawn one after the other from `generator` in sorted id order."""
    return {
        mid: rl_module.init(generator, s.obs_dim, s.num_actions, s.hidden,
                            device=device)
        for mid, s in sorted(spec.module_specs.items())
    }
