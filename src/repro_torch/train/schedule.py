"""Learning-rate schedules, as tensor ops (no host sync inside a step)."""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    final_frac: float = 0.1  # cosine floor as a fraction of peak


def warmup_cosine(step, cfg: ScheduleConfig) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to ``final_frac``
    of it.  ``step`` is an int or an integer tensor of any shape; the
    result is float32, on the step's device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.final_frac + (1 - cfg.final_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog)
    )
    return cfg.peak_lr * torch.where(s < cfg.warmup_steps, warm, cos)
