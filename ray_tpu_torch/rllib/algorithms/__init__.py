from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig

__all__ = ["IMPALA", "IMPALAConfig", "PPO", "PPOConfig"]
