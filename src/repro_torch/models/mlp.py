"""Dense MLPs (SwiGLU / GELU) and Mixture-of-Experts.

The MoE layer is the reference's single-shard path (``_moe_local``):
top-k routing in f32, a stable sort of the (token, choice) pairs by
expert, capacity bucketing with drops, batched expert FFNs and a weighted
combine.  On one card the reference takes that path too (no batch axes
in an active mesh); its expert- and ff-sharded ``shard_map`` paths wait
for the port's sharding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import dense_init, split_tree


# ---------------------------------------------------------------------------
# dense MLP
# ---------------------------------------------------------------------------
def init_mlp(gen, cfg: ModelConfig, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = common.pdtype(cfg)
    pairs = {
        "w_up": dense_init(gen, (d, f), dt, ("fsdp", "mlp")),
        "w_down": dense_init(gen, (f, d), dt, ("mlp", "fsdp")),
    }
    if cfg.mlp_gated:
        pairs["w_gate"] = dense_init(gen, (d, f), dt, ("fsdp", "mlp"))
    return split_tree(pairs)


def mlp_forward(params, x, cfg: ModelConfig):
    ct = common.cdtype(cfg)
    xc = x.to(ct)
    up = xc @ params["w_up"].to(ct)
    if cfg.mlp_gated:
        gate = xc @ params["w_gate"].to(ct)
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    return h @ params["w_down"].to(ct)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------
def init_moe(gen, cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.expert_ff, cfg.n_experts
    dt = common.pdtype(cfg)
    if cfg.moe_shard == "expert":
        up_axes = ("experts", "fsdp", None)
        down_axes = ("experts", None, "fsdp")
    else:  # "ff": few big experts — TP the hidden dim instead (grok-style)
        up_axes = (None, "fsdp", "mlp")
        down_axes = (None, "mlp", "fsdp")
    pairs = {
        "router": dense_init(gen, (d, e), torch.float32, (None, None)),
        "w_gate": dense_init(gen, (e, d, f), dt, up_axes),
        "w_up": dense_init(gen, (e, d, f), dt, up_axes),
        "w_down": dense_init(gen, (e, f, d), dt, down_axes),
    }
    return split_tree(pairs)


def _capacity(tokens_per_shard: int, cfg: ModelConfig) -> int:
    c = int(
        tokens_per_shard * cfg.top_k * cfg.capacity_factor / cfg.n_experts
    )
    return max(((c + 3) // 4) * 4, 4)


def _route(params, xl, cfg: ModelConfig):
    """Router: (T, D) → (probs (T,E) f32, top_p (T,k), top_e (T,k))."""
    logits = xl.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def _bucket(top_e, tl: int, k: int, e: int, cap: int):
    """Sort-based capacity positions: (order, sorted_e, src_tok, pos,
    keep), each (tl·k,)."""
    flat_e = top_e.reshape(tl * k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=top_e.device, dtype=sorted_e.dtype))
    pos_in_e = torch.arange(tl * k, device=top_e.device) - seg_start[sorted_e]
    keep = pos_in_e < cap
    src_tok = order // k
    return (order, sorted_e, src_tok,
            torch.where(keep, pos_in_e, torch.zeros_like(pos_in_e)), keep)


def _expert_ffn(buf, wg, wu, wd, ct):
    """(E, C, D) → (E, C, D) batched expert matmuls."""
    hg = torch.bmm(buf, wg.to(ct))
    hu = torch.bmm(buf, wu.to(ct))
    h = F.silu(hg) * hu
    return torch.bmm(h, wd.to(ct))


def _aux_loss(counts, prob_sum, total_tokens, cfg: ModelConfig):
    """Switch-style load-balance loss from expert counts + mean probs."""
    density = counts / max(total_tokens * cfg.top_k, 1.0)
    prob_mean = prob_sum / max(total_tokens, 1.0)
    return cfg.router_aux_coef * cfg.n_experts * torch.sum(
        density * prob_mean)


def _moe_local(params, xf, cfg: ModelConfig):
    """Single-shard MoE: xf (T, D) → (y (T, D), aux loss)."""
    ct = common.cdtype(cfg)
    tl, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(tl, cfg)
    probs, top_p, top_e = _route(params, xf, cfg)
    order, sorted_e, src, pos, keep = _bucket(top_e, tl, k, e, cap)
    contrib = torch.where(keep[:, None], xf[src].to(ct), 0)
    buf = torch.zeros((e, cap, d), dtype=ct, device=xf.device)
    buf.index_put_((sorted_e, pos), contrib, accumulate=True)
    out = _expert_ffn(
        buf, params["w_gate"], params["w_up"], params["w_down"], ct
    )
    gathered = out[sorted_e, pos]
    w = (top_p.reshape(tl * k)[order] * keep).to(ct)
    y = torch.zeros((tl, d), dtype=ct, device=xf.device)
    y.index_add_(0, src, gathered * w[:, None])
    counts = torch.zeros((e,), dtype=torch.float32, device=xf.device)
    counts.index_add_(0, top_e.reshape(-1),
                      torch.ones(tl * k, dtype=torch.float32,
                                 device=xf.device))
    aux = _aux_loss(counts, probs.sum(0), float(tl), cfg)
    return y, aux


def moe_forward(params, x, cfg: ModelConfig):
    """x: (B, S, D) → (B, S, D) + load-balance aux loss, on one device."""
    b, s, d = x.shape
    y, aux = _moe_local(params, x.reshape(b * s, d), cfg)
    return y.reshape(b, s, d), aux
