"""Baseline layouts the paper compares against (Sec 7.3)."""

from repro_torch.baselines.partitioners import random_layout, range_layout  # noqa: F401
from repro_torch.baselines.bottom_up import (  # noqa: F401
    BottomUpConfig,
    build_bottom_up,
)
