"""Serve step of the LM stack (greedy decode against the caches).

The reference's train step, optimizer, schedule, checkpoint and gradient
compression are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model


def serve_step(params, caches, token, pos: int, cfg: ModelConfig):
    """One decode step; greedy next token (the first maximum).
    → (next_token (B,1) int32, logits (B,V), caches updated in place)."""
    logits, caches = model.decode_step(params, caches, token, pos, cfg)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    return nxt, logits, caches
