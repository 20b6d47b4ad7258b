"""WOODBLOCK: deep-RL qd-tree construction (paper Sec 5)."""

from repro_torch.core.woodblock.agent import (  # noqa: F401
    Woodblock,
    WoodblockConfig,
    WoodblockResult,
    build_woodblock,
)
from repro_torch.core.woodblock.env import TreeEnv  # noqa: F401
from repro_torch.core.woodblock.ppo import PPOConfig  # noqa: F401
