"""Policy/value networks for WOODBLOCK (paper Sec 5.2.3), in PyTorch.

Shared trunk: two fully-connected layers of 512 units with ReLU.  Heads:
|A|-dim linear policy projection + scalar value projection, all float32.

Each layer keeps the JAX package's layout: a weight ``w`` of shape
(in, out) and a bias ``b``, applied as ``x @ w + b`` (not ``nn.Linear``,
which stores (out, in)), so :func:`params_from_jax` copies the reference's
arrays without a transpose and a state dict names them ``fc1.w``,
``fc1.b``, ... like the reference's parameter tree.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

HIDDEN = 512
LAYERS = ("fc1", "fc2", "policy", "value")


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` (in, out): the reference's dense layer."""

    def __init__(self, fan_in: int, fan_out: int, device=None):
        super().__init__()
        self.w = nn.Parameter(
            torch.zeros(fan_in, fan_out, dtype=torch.float32, device=device)
        )
        self.b = nn.Parameter(
            torch.zeros(fan_out, dtype=torch.float32, device=device)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class PolicyValueNet(nn.Module):
    """Two 512-unit ReLU layers, a policy head and a value head."""

    def __init__(self, in_dim: int, n_actions: int, hidden: int = HIDDEN,
                 device=None):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden, device)
        self.fc2 = Dense(hidden, hidden, device)
        self.policy = Dense(hidden, n_actions, device)
        self.value = Dense(hidden, 1, device)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (B, in_dim) → (logits (B, A), value (B,))."""
        h = torch.relu(self.fc1(x))
        h = torch.relu(self.fc2(h))
        return self.policy(h), self.value(h)[:, 0]


@torch.no_grad()
def init(net: PolicyValueNet, generator: torch.Generator) -> PolicyValueNet:
    """He-normal weights (std ``sqrt(2 / fan_in)``) and zero biases, drawn
    from ``generator`` on its own device, layer by layer."""
    for name in LAYERS:
        layer = getattr(net, name)
        fan_in = layer.w.shape[0]
        layer.w.copy_(
            torch.randn(layer.w.shape, generator=generator,
                        dtype=torch.float32, device=generator.device)
            * math.sqrt(2.0 / fan_in)
        )
        layer.b.zero_()
    return net


def make_net(in_dim: int, n_actions: int, generator: torch.Generator,
             hidden: int = HIDDEN, device=None) -> PolicyValueNet:
    """A freshly initialized net on ``device``."""
    return init(PolicyValueNet(in_dim, n_actions, hidden, device), generator)


def masked_log_softmax(logits: torch.Tensor,
                       legal: torch.Tensor) -> torch.Tensor:
    """Log-probabilities with illegal actions forced to ~-inf (the
    reference's mask value, ``finfo.min / 2``)."""
    neg = torch.finfo(logits.dtype).min / 2
    masked = torch.where(legal, logits, torch.full_like(logits, neg))
    return torch.log_softmax(masked, dim=-1)


@torch.no_grad()
def params_from_jax(params: dict, device=None) -> PolicyValueNet:
    """A net holding the reference's ``{"fc1","fc2","policy","value"}``
    dict of ``w`` (in, out) / ``b`` arrays (numpy or JAX), as they are."""
    w1 = np.asarray(params["fc1"]["w"])
    n_actions = np.asarray(params["policy"]["w"]).shape[1]
    net = PolicyValueNet(w1.shape[0], n_actions, w1.shape[1], device)
    for name in LAYERS:
        layer = getattr(net, name)
        for key in ("w", "b"):
            getattr(layer, key).copy_(torch.from_numpy(
                np.array(params[name][key], dtype=np.float32)))
    return net
