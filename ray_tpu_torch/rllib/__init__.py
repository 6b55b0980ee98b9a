"""ray_tpu_torch.rllib — reinforcement learning.

(reference: rllib/ — Algorithm/AlgorithmConfig, EnvRunnerGroup rollout
actors, Learner SGD. Here the learner's params and Adam state live on the
card (``.learners(device=)``; None is the card) and the env runners are CPU
actors with their own CPU copy of the module.)

Ported: the core, PPO (with its multi-agent path) and DQN. The other
algorithms of the JAX package raise, naming their ROADMAP.md item, where a
user reaches them.
"""

from ray_tpu_torch.exceptions import _not_ported
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.env import (CartPoleVecEnv, PendulumVecEnv,
                                     VectorEnv, make_vec_env)
from ray_tpu_torch.rllib.env_runner import EnvRunner, EnvRunnerGroup
from ray_tpu_torch.rllib.learner import Learner, compute_gae
from ray_tpu_torch.rllib.multi_agent_env import (CoordinationGameVecEnv,
                                                 MultiAgentCartPoleVecEnv,
                                                 MultiAgentVecEnv,
                                                 make_multi_agent_env)
from ray_tpu_torch.rllib.multi_agent_runner import (MultiAgentEnvRunner,
                                                    MultiAgentEnvRunnerGroup)
from ray_tpu_torch.rllib.multi_rl_module import (MultiRLModuleSpec,
                                                 RLModuleSpec, init_multi)
from ray_tpu_torch.rllib.replay import ReplayBuffer

# the JAX package's algorithms not ported yet (ROADMAP.md Queue 1 item 14)
NOT_PORTED = ("APPO", "APPOConfig", "BC", "BCConfig", "CQL", "CQLConfig",
              "DreamerV3", "DreamerV3Config", "IMPALA", "IMPALAConfig",
              "IQL", "IQLConfig", "MARWIL", "MARWILConfig", "SAC",
              "SACConfig")


def __getattr__(name):
    if name in NOT_PORTED:
        raise _not_ported(f"ray_tpu_torch.rllib.{name}", "item 14")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "DQN",
    "DQNConfig",
    "ReplayBuffer",
    "CartPoleVecEnv",
    "PendulumVecEnv",
    "EnvRunner",
    "EnvRunnerGroup",
    "Learner",
    "PPO",
    "PPOConfig",
    "VectorEnv",
    "CoordinationGameVecEnv",
    "MultiAgentCartPoleVecEnv",
    "MultiAgentVecEnv",
    "MultiAgentEnvRunner",
    "MultiAgentEnvRunnerGroup",
    "MultiRLModuleSpec",
    "RLModuleSpec",
    "compute_gae",
    "init_multi",
    "make_multi_agent_env",
    "make_vec_env",
]
