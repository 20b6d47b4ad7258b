"""Proximal Policy Optimization in PyTorch (paper Sec 5.2: PPO is the
black-box update rule).

The tree-structured MDP treats each node as an independent state whose
normalized reward *is* its return (no discounting across the tree — Sec
5.2.4), so advantages are simply ``R - V(s)``.  Gradients come from
autograd; the global-norm clipping and the Adam step are written out by
hand, as in the JAX package, so one update can be held against the
reference's (``params_from_jax`` / :func:`adam_state_from_jax` carry its
weights and optimizer state across).  Nothing is padded to a bucket:
PyTorch does not retrace per shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.woodblock import networks


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    lr: float = 3e-4
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    epochs: int = 4
    buffer_cap: int = 2048
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    max_grad_norm: float = 0.5


def _named(net: networks.PolicyValueNet) -> dict[str, torch.nn.Parameter]:
    return dict(net.named_parameters())


# -- minimal Adam, the reference's: bias-corrected, eps added to sqrt(v̂) ----
def adam_init(net: networks.PolicyValueNet) -> dict:
    params = _named(net)
    return {
        "m": {k: torch.zeros_like(p) for k, p in params.items()},
        "v": {k: torch.zeros_like(p) for k, p in params.items()},
        "t": 0,
    }


@torch.no_grad()
def adam_update(net: networks.PolicyValueNet, grads: dict, state: dict,
                cfg: PPOConfig) -> dict:
    """One Adam step on ``net``'s parameters, in place; returns the new
    state."""
    t = state["t"] + 1
    bc1 = 1.0 - cfg.adam_b1 ** t
    bc2 = 1.0 - cfg.adam_b2 ** t
    m_new, v_new = {}, {}
    for k, p in _named(net).items():
        g = grads[k]
        m = cfg.adam_b1 * state["m"][k] + (1 - cfg.adam_b1) * g
        v = cfg.adam_b2 * state["v"][k] + (1 - cfg.adam_b2) * g * g
        p.sub_(cfg.lr * (m / bc1) / (torch.sqrt(v / bc2) + cfg.adam_eps))
        m_new[k], v_new[k] = m, v
    return {"m": m_new, "v": v_new, "t": t}


def adam_state_from_jax(state: dict, device=None) -> dict:
    """The reference's ``{"m": tree, "v": tree, "t": int32}`` as this
    module's state, keyed ``"fc1.w"``, ``"fc1.b"``, ..."""

    def flat(tree):
        return {
            f"{name}.{key}": torch.from_numpy(
                np.array(tree[name][key], dtype=np.float32)
            ).to(device)
            for name in networks.LAYERS
            for key in ("w", "b")
        }

    return {"m": flat(state["m"]), "v": flat(state["v"]),
            "t": int(np.asarray(state["t"]))}


def ppo_loss(net: networks.PolicyValueNet, batch: dict, cfg: PPOConfig):
    logits, values = net(batch["states"])
    logp_all = networks.masked_log_softmax(logits, batch["legal"])
    logp = logp_all.gather(1, batch["actions"].long()[:, None])[:, 0]
    ratio = torch.exp(logp - batch["old_logp"])
    adv = batch["advantages"]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
    w = batch["weight"]
    denom = torch.clamp(w.sum(), min=1.0)
    policy_loss = -(torch.minimum(unclipped, clipped) * w).sum() / denom
    value_loss = (((values - batch["returns"]) ** 2) * w).sum() / denom
    probs = torch.exp(logp_all)
    entropy = -(
        (probs * torch.where(batch["legal"], logp_all,
                             torch.zeros_like(logp_all))).sum(dim=1) * w
    ).sum() / denom
    total = (
        policy_loss
        + cfg.value_coef * value_loss
        - cfg.entropy_coef * entropy
    )
    return total, {
        "policy_loss": policy_loss.detach(),
        "value_loss": value_loss.detach(),
        "entropy": entropy.detach(),
    }


def ppo_update(net: networks.PolicyValueNet, opt_state: dict, batch: dict,
               cfg: PPOConfig):
    """One clipped-PPO step: autograd, global-norm clipping, Adam.

    Updates ``net`` in place; returns ``(net, opt_state, aux)``, with
    ``aux`` tensors on the net's device (nothing is copied back).
    """
    params = _named(net)
    total, aux = ppo_loss(net, batch, cfg)
    grads = dict(zip(params, torch.autograd.grad(total,
                                                 list(params.values()))))
    gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = torch.clamp(cfg.max_grad_norm / (gnorm + 1e-8), max=1.0)
    grads = {k: g * scale for k, g in grads.items()}
    opt_state = adam_update(net, grads, opt_state, cfg)
    aux["grad_norm"] = gnorm.detach()
    return net, opt_state, aux


@torch.no_grad()
def policy_step(net: networks.PolicyValueNet, states: torch.Tensor,
                legal: torch.Tensor, generator: torch.Generator):
    """Sample actions for a batch of states (used inside episodes):
    categorical draws from ``generator``, which lies on the net's device.
    Returns ``(actions int64, logp, values)`` on that device."""
    logits, values = net(states)
    logp_all = networks.masked_log_softmax(logits, legal)
    actions = torch.multinomial(torch.exp(logp_all), 1,
                                generator=generator)[:, 0]
    logp = logp_all.gather(1, actions[:, None])[:, 0]
    return actions, logp, values


SCALARS = ("actions", "old_logp", "returns", "advantages", "weight")


def make_batch(transitions, cap: int, n_actions: int, feat_dim: int,
               device=None) -> dict[str, torch.Tensor]:
    """A PPO batch of ``cap`` rows on ``device``, the first
    ``min(len(transitions), cap)`` real (``weight`` 1): the reference's
    ``make_batch`` on the host, then copied over in one transfer (every
    field packed as float32 columns of one array — the 0/1 masks and the
    action ids < 2**24 are exact there) and split on the device."""
    n = min(len(transitions), cap)
    states = np.zeros((cap, feat_dim), np.float32)
    legal = np.zeros((cap, n_actions), bool)
    actions = np.zeros((cap,), np.int32)
    old_logp = np.zeros((cap,), np.float32)
    returns = np.zeros((cap,), np.float32)
    values = np.zeros((cap,), np.float32)
    weight = np.zeros((cap,), np.float32)
    for i, t in enumerate(transitions[:cap]):
        states[i] = t.state
        legal[i] = t.legal
        actions[i] = t.action
        old_logp[i] = t.logp
        returns[i] = t.reward
        values[i] = t.value
        weight[i] = 1.0
    adv = returns - values
    # normalize advantages over valid rows
    if n > 1:
        mu = adv[:n].mean()
        sd = adv[:n].std() + 1e-8
        adv = np.where(weight > 0, (adv - mu) / sd, 0.0)
    legal[weight == 0, 0] = True  # keep padded rows' softmax well-defined
    packed = np.concatenate(
        [states, legal, np.stack([actions, old_logp, returns, adv, weight],
                                 axis=1)], axis=1, dtype=np.float32)
    buf = torch.from_numpy(packed).to(device)
    f, a = feat_dim, n_actions
    cols = {k: buf[:, f + a + i] for i, k in enumerate(SCALARS)}
    cols["actions"] = cols["actions"].to(torch.int32)
    return {"states": buf[:, :f], "legal": buf[:, f:f + a] > 0.5, **cols}
