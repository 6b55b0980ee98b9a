"""ray_tpu_torch.rllib — reinforcement learning.

(reference: rllib/ — Algorithm/AlgorithmConfig, EnvRunnerGroup rollout
actors, Learner SGD. Here the learner's params and Adam state live on the
card (``.learners(device=)``; None is the card) and the env runners are CPU
actors with their own CPU copy of the module.)

Ported: the core, PPO (with its multi-agent path), DQN, IMPALA, APPO, SAC,
BC, MARWIL, CQL, IQL and DreamerV3.
"""

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.appo import APPO, APPOConfig
from ray_tpu_torch.rllib.algorithms.bc import BC, BCConfig
from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.dreamerv3 import (DreamerV3,
                                                      DreamerV3Config)
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.iql import IQL, IQLConfig
from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
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

# every algorithm of the JAX package is ported
NOT_PORTED = ()

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "APPO",
    "APPOConfig",
    "BC",
    "BCConfig",
    "CQL",
    "CQLConfig",
    "DQN",
    "DQNConfig",
    "DreamerV3",
    "DreamerV3Config",
    "IMPALA",
    "IMPALAConfig",
    "IQL",
    "IQLConfig",
    "MARWIL",
    "MARWILConfig",
    "ReplayBuffer",
    "CartPoleVecEnv",
    "PendulumVecEnv",
    "EnvRunner",
    "EnvRunnerGroup",
    "Learner",
    "PPO",
    "PPOConfig",
    "SAC",
    "SACConfig",
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
