from ray_tpu_torch.exceptions import _not_ported
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig

__all__ = ["PPO", "PPOConfig"]


def __getattr__(name):
    if name in ("IMPALA", "IMPALAConfig"):
        raise _not_ported(f"ray_tpu_torch.rllib.algorithms.{name}",
                          "item 14")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
