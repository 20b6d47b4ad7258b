"""Shared model components: norms, RoPE, param init with logical-axis specs.

Every ``init_*`` returns ``(params, specs)`` where ``specs`` mirrors the
param tree with tuples of logical axis names, as the reference's do.
Params are plain dicts of tensors; mixed precision policy: params live in
``cfg.param_dtype``, matmuls run in ``cfg.compute_dtype``, normalizations,
softmax and losses in float32.  Weights are drawn from an explicit
``torch.Generator`` on the device the params live on.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.engine.plan import resolve_device
from repro_torch.sharding import specs as sh
from repro_torch.sharding.specs import batch_only, shard_local

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


def make_generator(seed: int, device=None) -> torch.Generator:
    """A generator seeded with ``seed`` on ``device`` (None: the GPU,
    raising without one); weights drawn from it are made on that device."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, axes, scale=None):
    """Truncated-normal (±2σ) init with fan-in scaling + logical axes."""
    if gen.device.type == "meta":  # shapes only (``abstract_state``)
        return torch.empty(shape, dtype=dtype, device="meta"), axes
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(s).to(dtype), axes


def split_tree(pairs: dict):
    """{'name': (param, axes)} → (params dict, specs dict)."""
    params = {k: v[0] for k, v in pairs.items()}
    specs = {k: v[1] for k, v in pairs.items()}
    return params, specs


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x, scale, eps: float):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layernorm(x, scale, bias, eps: float):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, H, hd); positions: (B, S) int.  Half-split pairs: the
    first half of each head rotates against its second half."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# cross-entropy (fp32, label smoothing-free, z-loss optional)
# ---------------------------------------------------------------------------
def _vocab_split(logits):
    """Under a mesh whose ``vocab`` axes have more than one rank: (the
    mesh, the logits' fitted spec, those axes); else None.  Where the
    axes do not divide the vocab the fitted spec leaves it whole, and
    each rank takes its ceil(V / ranks) share of it
    (``_vocab_parallel_nll``), unless some rank's share would be empty."""
    mesh, rules = sh.active_mesh(), sh.active_rules()
    if mesh is None or rules is None or not isinstance(logits, sh.DTensor):
        return None
    spec = sh.fitted_spec(tuple(logits.shape), ("batch", None, "vocab"),
                          mesh, rules)
    sizes = sh.axis_sizes(mesh)
    vocab = sh.axes_of(sh.P(spec[2])) or set(rules.lookup("vocab") or ())
    axes = tuple(a for a in mesh.mesh_dim_names
                 if a in vocab and sizes[a] > 1
                 and a not in sh.axes_of(sh.P(spec[0])))
    ranks, v = math.prod(sizes[a] for a in axes), logits.shape[-1]
    if not axes or (ranks - 1) * -(-v // ranks) >= v:
        return None
    return mesh, spec, axes


class _VocabSum(torch.autograd.Function):
    """Sum over the ranks that split the vocab, for a result every one of
    them holds whole (replicated): the backward passes each rank's
    gradient through, since each rank's part enters the sum once."""

    @staticmethod
    def forward(ctx, x, groups):
        y = x.clone()
        for g in groups:
            torch.distributed.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _vocab_parallel_nll(logits, labels, mesh, spec, axes):
    """(logsumexp, nll) over the vocab's ranks, the reference's layout:
    each rank reduces its own vocab slice (max, sum of exps, the label's
    logit where its slice holds the label) and the parts are summed over
    the vocab's ranks, so no rank holds the whole vocab in float32.  Each
    rank works on its batch rows; both results are laid out over them and
    replicated over the vocab's axes."""
    groups = [mesh.get_group(a) for a in axes]
    rows = sh.P(spec[0], None)
    index = sh.axes_index(mesh, axes)
    if spec[2] is not None:  # the logits split along the vocab
        lg = sh.take_local(logits, spec, mesh).float()
        v0 = index * lg.shape[-1]
    else:  # whole on every rank: each takes its share, its grad partial
        share = -(-logits.shape[-1] // math.prod(
            sh.axis_sizes(mesh)[a] for a in axes))
        v0 = index * share
        lg = sh.take_local(logits, spec, mesh, set(axes))[
            ..., v0:v0 + share].float()
    y = sh.take_local(labels, rows, mesh)
    width = lg.shape[-1]
    m = lg.detach().amax(dim=-1)
    for g in groups:
        torch.distributed.all_reduce(m, torch.distributed.ReduceOp.MAX,
                                     group=g)
    se = _VocabSum.apply(torch.exp(lg - m[..., None]).sum(dim=-1), groups)
    lse = torch.log(se) + m
    off = y.long() - v0
    mine = (off >= 0) & (off < width)
    hit = torch.gather(lg, -1, off.clamp(0, width - 1)[..., None])[..., 0]
    ll = _VocabSum.apply(torch.where(mine, hit, 0.0), groups)
    return (sh.from_local(lse, rows, mesh),
            sh.from_local(lse - ll, rows, mesh))


class _SliceLookup(torch.autograd.Function):
    """The rows ``off`` of a table's vocab slice, zeros where ``off``
    falls outside it; saves only the offsets, as the whole table's
    lookup saves the ids."""

    @staticmethod
    def forward(ctx, local, off):
        ctx.width = local.shape[0]
        ctx.save_for_backward(off)
        mine = (off >= 0) & (off < ctx.width)
        return F.embedding(torch.where(mine, off, 0), local).masked_fill_(
            ~mine[..., None], 0)

    @staticmethod
    def backward(ctx, g):
        (off,) = ctx.saved_tensors
        mine = (off >= 0) & (off < ctx.width)
        g = g.masked_fill(~mine[..., None], 0)
        return torch.ops.aten.embedding_dense_backward(
            g, torch.where(mine, off, 0), ctx.width, -1, False), None


def embed_lookup(table, ids):
    """``F.embedding(ids, table)``: the rows of a (V, D) table.  Where the
    table is split along the vocab over ranks (a DTensor, under active
    rules), each rank looks up the ids that fall in its slice, zeros the
    rest and the parts are summed over the vocab's ranks: the
    reference's lookup on a vocab-split table.  One real row plus zeros,
    so the values are the whole table's bit for bit, and no rank gathers
    the table or its gradient, which stays on each rank's slice (partial
    over the axes that split the batch).  Each rank works on its batch
    rows; the result is laid out over them and replicated over the
    vocab's axes.  Elsewhere (no mesh, a plain table, a vocabulary the
    axes do not divide, which ``fitted_spec`` leaves whole) the table is
    gathered first: a lookup on a sharded table has no DTensor rule."""
    rules = sh.active_rules()
    if not isinstance(table, sh.DTensor) or rules is None \
            or sh.spec_of(table)[0] is None:
        return F.embedding(ids.long(), sh.replicate(table))
    mesh = table.device_mesh
    vocab = sh.spec_of(table)[0]
    rows = sh.fitted_spec(tuple(ids.shape), ("batch",) + (None,) * (
        ids.dim() - 1), mesh, rules)
    axes = sh.axes_of(sh.P(vocab))
    if axes & sh.axes_of(rows):
        raise ValueError(f"the batch {rows} and the vocab {vocab} share "
                         "a mesh axis")
    local = sh.take_local(table, sh.P(vocab, None), mesh, sh.axes_of(rows))
    width = local.shape[0]
    off = sh.take_local(ids, rows, mesh).long() - sh.axes_index(
        mesh, axes) * width
    part = _SliceLookup.apply(local, off)
    groups = [mesh.get_group(a) for a in mesh.mesh_dim_names if a in axes]
    return sh.from_local(_VocabSum.apply(part, groups),
                         sh.P(*rows, None), mesh)


def softmax_cross_entropy(logits, labels, weights=None,
                          z_loss_coef: float = 1e-4):
    """logits (..., V) any dtype → fp32 loss; returns (loss, mean_nll).

    ``weights`` (same shape as labels) masks positions (e.g. VLM image
    slots); the mean is over the weighted token count.
    """
    split = _vocab_split(logits)
    if split is not None:
        lse, nll = _vocab_parallel_nll(logits, labels, *split)
    else:
        # under a mesh whose axes do not split the vocab: the label gather
        # has no DTensor rule over a partial sum, and its backward's
        # scatter none over a batch split (every rank would scatter the
        # whole batch): both on each rank's rows
        lg = batch_only(logits).float()
        lse = torch.logsumexp(lg, dim=-1)
        ll = shard_local(
            lambda lg, y: torch.gather(lg, -1, y[..., None].long())[..., 0],
            (lg, labels), (("batch", None, None), ("batch", None)),
            ("batch", None))
        nll = lse - ll
    z = z_loss_coef * (lse ** 2)
    if weights is None:
        return nll.mean() + z.mean(), nll.mean()
    w = weights.float()
    denom = torch.clamp(w.sum(), min=1.0)
    mean_nll = (nll * w).sum() / denom
    return mean_nll + (z * w).sum() / denom, mean_nll
