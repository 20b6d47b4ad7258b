"""Dense MLPs (SwiGLU / GELU) and Mixture-of-Experts.

The MoE layer's single-shard path (``_moe_local``): top-k routing in
f32, a stable sort of the (token, choice) pairs by expert, capacity
bucketing with drops, batched expert FFNs and a weighted combine.

Under an active mesh whose batch axes divide the batch, the layer runs as
the reference's fully-manual ``shard_map`` region: each input's shard on
this rank is taken as a plain tensor and the body runs with explicit
collectives over the mesh's sub-groups:

  * tokens stay in their (pod, data) shard (and, with expert parallelism,
    their ``model`` slice of the sequence); top-k, sort, capacity
    bucketing and the combine are shard-local,
  * ``moe_shard="expert"`` (EP): one ``all_to_all`` over ``model`` each
    way around the expert FFNs, which run on E/|model| local experts with
    an FSDP ``all_gather`` of their weights over ``data``,
  * ``moe_shard="ff"``: each model rank computes its F-slice and a psum
    over ``model`` adds the partial outputs,
  * the load-balance loss psums token statistics over the token axes.

The collectives carry gradients (``funcol``'s autograd all-to-all and
all-gather, whose backwards are the reverse all-to-all and a
reduce-scatter; a psum whose backward is a psum).  Gradients are the true
ones of the layer: a replica that computes the same tokens as another
(tokens replicated over ``model`` in the ff path) passes back its share,
and a shard's input gradient is summed over the ranks it is replicated
on.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import dense_init, split_tree
from repro_torch.sharding import specs
from repro_torch.sharding.specs import P
from repro_torch.sharding.specs import logical_constraint as wsc


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
    h = wsc(h, ("batch", "seq", "mlp"))
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


def _by_token(order, tl: int, k: int):
    """(tl, k): each token's rows of the expert-sorted order, ascending,
    the order in which a serial scatter-add (the CPU's ``index_add_``)
    visits them."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return inv.reshape(tl, k).sort(dim=1).values


def _ordered_sum(rows, by_token):
    """Each token's rows summed from zero in ``by_token``'s order: the
    serial scatter-add's sums, with no atomics."""
    out = torch.zeros((by_token.shape[0],) + rows.shape[1:],
                      dtype=rows.dtype, device=rows.device)
    for r in range(by_token.shape[1]):
        out = out + rows[by_token[:, r]]
    return out


class _Dispatch(torch.autograd.Function):
    """``x[src]``: each token's row once for each of its k choices, in the
    expert-sorted order; the backward sums a token's k gradient rows in a
    fixed order (``_ordered_sum``) where a scatter into repeated rows would
    add them with atomics on the card."""

    @staticmethod
    def forward(ctx, x, src, by_token):
        ctx.save_for_backward(by_token)
        return x[src]

    @staticmethod
    def backward(ctx, g):
        (by_token,) = ctx.saved_tensors
        return _ordered_sum(g, by_token), None, None


class _Combine(torch.autograd.Function):
    """The combine: each token's k weighted expert outputs (rows in the
    expert-sorted order) summed in a fixed order, as ``index_add_`` adds
    them on the CPU; the backward gathers each row's token gradient."""

    @staticmethod
    def forward(ctx, rows, src, by_token):
        ctx.save_for_backward(src)
        return _ordered_sum(rows, by_token)

    @staticmethod
    def backward(ctx, g):
        (src,) = ctx.saved_tensors
        return g[src], None, None


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
    by_token = _by_token(order, tl, k)
    contrib = torch.where(keep[:, None],
                          _Dispatch.apply(xf, src, by_token).to(ct), 0)
    # a kept row owns its slot; the dropped ones add zeros at slot 0
    buf = torch.zeros((e, cap, d), dtype=ct, device=xf.device)
    buf.index_put_((sorted_e, pos), contrib, accumulate=True)
    out = _expert_ffn(
        buf, params["w_gate"], params["w_up"], params["w_down"], ct
    )
    gathered = out[sorted_e, pos]
    w = (top_p.reshape(tl * k)[order] * keep).to(ct)
    y = _Combine.apply(gathered * w[:, None], src, by_token)
    counts = torch.zeros((e,), dtype=torch.float32, device=xf.device)
    counts.index_add_(0, top_e.reshape(-1),
                      torch.ones(tl * k, dtype=torch.float32,
                                 device=xf.device))
    aux = _aux_loss(counts, probs.sum(0), float(tl), cfg)
    return y, aux


class _PSum(torch.autograd.Function):
    """Sum over a process group; its backward sums the gradients over
    the group too (the exact adjoint)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ScaleGrad(torch.autograd.Function):
    """Identity whose backward scales the gradient by ``c``."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def _psum(x, mesh, axes: tuple):
    for a in axes:
        x = _PSum.apply(x, mesh.get_group(a))
    return x


def _moe_sharded(params, x, cfg: ModelConfig, mesh, batch_axes, sizes):
    """The reference's ``shard_map`` body on this rank's shards."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    ct = common.cdtype(cfg)
    n_tok_shards = math.prod(sizes[a] for a in batch_axes)
    n_model = sizes.get("model", 1)
    has_model = "model" in sizes
    ep = cfg.moe_shard == "expert" and has_model and e % n_model == 0
    ff_tp = (cfg.moe_shard == "ff" and has_model
             and cfg.expert_ff % n_model == 0)
    # EP + sequence-parallel dispatch: each model rank routes only its own
    # slice of the sequence (else the a2a repeats every row n_model times)
    seq_split = ep and s % n_model == 0 and s >= n_model
    tl = (b // n_tok_shards) * (s // (n_model if seq_split else 1))
    cap = _capacity(tl, cfg)
    tok_axes = batch_axes + (("model",) if seq_split else ())

    if ep:
        w_specs = {"router": P(None, None),
                   "w_gate": P("model", "data", None),
                   "w_up": P("model", "data", None),
                   "w_down": P("model", None, "data")}
    elif ff_tp:
        w_specs = {"router": P(None, None),
                   "w_gate": P(None, "data", "model"),
                   "w_up": P(None, "data", "model"),
                   "w_down": P(None, "model", "data")}
    else:
        w_specs = {"router": P(None, None),
                   "w_gate": P(None, "data", None),
                   "w_up": P(None, "data", None),
                   "w_down": P(None, None, "data")}
    has_data = "data" in sizes
    if not has_data:
        w_specs = {n: P(*[None] * len(v)) for n, v in w_specs.items()}
    x_spec = P(batch_axes, "model" if seq_split else None, None)

    p = {n: specs.take_local(params[n], w_specs[n], mesh, True) for n in w_specs}
    xl = specs.take_local(x, x_spec, mesh, True).reshape(tl, d)
    probs, top_p, top_e = _route(p, xl, cfg)
    order, sorted_e, src, pos, keep = _bucket(top_e, tl, k, e, cap)
    by_token = _by_token(order, tl, k)
    contrib = torch.where(keep[:, None],
                          _Dispatch.apply(xl, src, by_token).to(ct), 0)
    buf = torch.zeros((e, cap, d), dtype=ct, device=xl.device)
    buf = buf.index_put((sorted_e, pos), contrib, accumulate=True)

    def gather(w, ax):  # FSDP: the expert weights' data shards, whole
        if not has_data:
            return w
        return funcol.all_gather_tensor_autograd(
            w, gather_dim=ax, group=mesh.get_group("data"))

    wg, wu, wd = (gather(p["w_gate"], 1), gather(p["w_up"], 1),
                  gather(p["w_down"], 2))
    if ep:
        # experts ↔ capacity all-to-all (the EP boundary): rank j gets
        # every rank's rows for its E/n experts, in rank order
        el = e // n_model
        pg = mesh.get_group("model")
        sent = funcol.all_to_all_single_autograd(
            buf.reshape(n_model, el, cap, d), None, None, pg)
        sent = funcol.wait_tensor(sent)
        local_in = sent.permute(1, 0, 2, 3).reshape(el, n_model * cap, d)
        out = _expert_ffn(local_in, wg, wu, wd, ct)
        back = out.reshape(el, n_model, cap, d).permute(1, 0, 2, 3)
        back = funcol.all_to_all_single_autograd(
            back.contiguous(), None, None, pg)
        out = funcol.wait_tensor(back).reshape(e, cap, d)
    elif ff_tp:
        # partial-F expert compute + psum over model
        out = _psum(_expert_ffn(buf, wg, wu, wd, ct), mesh, ("model",))
    else:
        out = _expert_ffn(buf, wg, wu, wd, ct)
    gathered = out[sorted_e, pos]
    w = (top_p.reshape(tl * k)[order] * keep).to(ct)
    y = _Combine.apply(gathered * w[:, None], src, by_token)
    counts = torch.zeros((e,), dtype=torch.float32, device=xl.device)
    counts.index_add_(0, top_e.reshape(-1),
                      torch.ones(tl * k, dtype=torch.float32,
                                 device=xl.device))
    with torch.no_grad():
        counts = _psum(counts, mesh, tok_axes)
    prob_sum = _psum(probs.sum(0), mesh, tok_axes)
    aux = _aux_loss(counts, prob_sum, float(b * s), cfg)

    # each token row is computed on n_rep ranks and the aux loss on all:
    # every copy gets the whole gradient back, so each passes back its
    # share (the reference's division of replicated cotangents)
    n_rep = math.prod(sizes.values()) // math.prod(
        sizes[a] for a in tok_axes)
    if n_rep > 1:
        y = _ScaleGrad.apply(y, 1.0 / n_rep)
    if math.prod(sizes.values()) > 1:
        aux = _ScaleGrad.apply(aux, 1.0 / math.prod(sizes.values()))
    y = y.reshape(b // n_tok_shards, s // (n_model if seq_split else 1), d)
    return specs.from_local(y, x_spec, mesh), specs.from_local(aux, P(), mesh)


def moe_forward(params, x, cfg: ModelConfig):
    """x: (B, S, D) → (B, S, D) + load-balance aux loss.

    Under an active mesh whose batch axes divide B, the sharded body runs
    (see the module docstring) and, for DTensor input, its output is a
    DTensor laid out as the body's tokens; for plain input (the full
    tensor on every rank) it is the full tensor.  Without a mesh, or when
    the batch does not divide, the single-shard path runs (on whole
    tensors under a mesh).
    """
    b, s, d = x.shape
    mesh = specs.active_mesh()
    rules = specs.active_rules()
    sizes = specs.axis_sizes(mesh) if mesh is not None else {}
    batch_axes = ()
    if mesh is not None and rules is not None:
        batch_axes = tuple(a for a in (rules.lookup("batch") or ())
                           if a in sizes)
    n_tok_shards = math.prod(sizes[a] for a in batch_axes)
    if not batch_axes or b % n_tok_shards:
        names = ("router", "w_gate", "w_up", "w_down")

        def local(xx, *ws):
            y, aux = _moe_local(dict(zip(names, ws)), xx.reshape(b * s, d),
                                cfg)
            return y.reshape(b, s, d), aux

        # replicated whole on every rank: sort and scatter have no
        # DTensor rule
        return specs.shard_local(
            local, (x,) + tuple(params[n] for n in names),
            ((None,) * 3,) + tuple((None,) * params[n].dim()
                                   for n in names),
            ((None,) * 3, ()))
    y, aux = _moe_sharded(params, x, cfg, mesh, batch_axes, sizes)
    if not isinstance(x, DTensor):
        return y.full_tensor(), aux.full_tensor()
    return y, aux
