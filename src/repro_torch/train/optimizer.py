"""AdamW with optional int8 block-quantized moments.

Two state formats, as the reference's:

* fp32 moments (default): ``{"m": f32, "v": f32}`` per param.
* int8 moments (``eight_bit``): each moment of a leaf of rank ≥ 2 is
  ``{"q": int8 (param shape), "scale": f32 (param.shape[:-1] + (1,))}``,
  per-row (last-axis) absmax scaling; lower ranks stay fp32.

Weight decay is decoupled (AdamW) and applied to rank ≥ 2 leaves only.
Rank is the reference's: it stacks each layer group's leaves on a leading
axis, so a leaf inside the port's per-group lists (a norm scale of shape
``(d,)``) counts one more (the reference's ``(n_groups, d)``), is decayed
and, with ``eight_bit``, quantized.  Row by row that is the same
arithmetic as the reference's on its stacked leaf.

``adamw_update`` updates the params and the moments in place, the
counterpart of the reference's donated state: at full width a second copy
of the state would not fit the card.  On DTensor leaves (a sharded
state) each rank updates its own shards as plain tensors: the update is
elementwise but for the clip's global norm (reduced over the mesh) and an
int8 moment's row absmax, which is all-reduced over the mesh dims that
split the row, so a sharded update equals the unsharded one.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.model import leaves
from repro_torch.sharding import specs as sh


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    eight_bit: bool = False


# ---------------------------------------------------------------------------
# int8 moment quantization
# ---------------------------------------------------------------------------
def quantize(x: torch.Tensor, row_groups: tuple = ()) -> dict:
    """Per-row (last-axis) absmax int8 quantization.  ``x`` may be a shard
    whose rows continue on the ranks of ``row_groups``: the absmax is then
    the whole row's."""
    absmax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    for group in row_groups:
        dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(absmax, min=1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def dequantize(qs: dict) -> torch.Tensor:
    return qs["q"].to(torch.float32) * qs["scale"]


def _moment_get(s) -> torch.Tensor:
    return dequantize(s) if isinstance(s, dict) else s


def _moment_set(old, new: torch.Tensor, row_groups: tuple = ()) -> None:
    """Store ``new`` into an int8 moment; an fp32 one was updated where it
    lies (``_moment_get`` returned the state's own tensor)."""
    if isinstance(old, dict):
        qs = quantize(new, row_groups)
        old["q"].copy_(qs["q"])
        old["scale"].copy_(qs["scale"])


def _zip_map(fn, tree, *others, stacked: bool = False):
    """``fn(leaf, *other_leaves, ref_ndim)`` over ``tree``'s leaves, with
    ``others`` indexed alike (a moment's ``{"q", "scale"}`` is one leaf).
    A list is a layer stack: below it ``ref_ndim`` is one more than the
    leaf's own rank (the reference's stacked rank)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, *(o[k] for o in others), stacked=stacked)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, *(o[i] for o in others), stacked=True)
                for i, v in enumerate(tree)]
    return fn(tree, *others, tree.dim() + stacked)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    def one(p, ref_ndim):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if not (cfg.eight_bit and ref_ndim >= 2):
            return z
        if p.device.type == "meta":  # shapes only (``abstract_state``)
            return {"q": z.to(torch.int8), "scale": z[..., :1]}
        return quantize(z)

    dev = next(leaves(params)).device
    return {
        "m": _zip_map(one, params),
        "v": _zip_map(one, params),
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def opt_state_specs(param_specs, cfg: AdamWConfig) -> dict:
    """Logical-axis specs mirroring ``adamw_init``'s state tree."""

    def one(axes, stacked):
        if cfg.eight_bit and len(axes) + stacked >= 2:
            return {"q": axes, "scale": axes[:-1] + (None,)}
        return axes

    def walk(t, stacked=False):
        if isinstance(t, dict):
            return {k: walk(v, stacked) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, True) for v in t]
        return one(t, stacked)

    mspec = walk(param_specs)
    return {"m": mspec, "v": mspec, "count": ()}


def _shards(p, g, m_s, v_s):
    """A sharded leaf's local shards: p's, the grad laid out as p, and the
    moments (placed as p by the state's shardings); and the process
    groups of the mesh dims that split its rows."""
    if not isinstance(p, DTensor):
        return p, g, m_s, v_s, ()
    mesh, want, last = p.device_mesh, tuple(p.placements), p.dim() - 1
    row = tuple(Replicate() if pl.is_shard(last) else pl for pl in want)

    def own(t):  # a moment, or an int8 one's codes (as p) and scales (row)
        if isinstance(t, dict):
            return {k: own(v) for k, v in t.items()}
        if tuple(t.placements) not in (want, row):
            raise ValueError(f"a moment laid out as {t.placements}, its "
                             f"param as {want}")
        return t.to_local()

    groups = tuple(mesh.get_group(i) for i, pl in enumerate(want)
                   if pl.is_shard(last))
    g = g.redistribute(mesh, want).to_local()
    return p.to_local(), g, own(m_s), own(v_s), groups


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state, lr, cfg: AdamWConfig):
    """One AdamW step, leaf by leaf in the reference's order of operations.
    ``lr`` is a float or a 0-d tensor (from the schedule).  Updates
    ``params`` and the moments in place; → (params, opt state, grad
    norm)."""
    count = state["count"] + 1
    gnorm = sh.local(sh.replicate(global_norm(grads)))
    clip = torch.clamp(cfg.max_grad_norm / (gnorm + 1e-12), max=1.0)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=count.device)
    bc1 = 1.0 - cfg.b1 ** count.to(torch.float32)
    bc2 = 1.0 - cfg.b2 ** count.to(torch.float32)

    def upd(p, g, m_s, v_s, ref_ndim):
        p, g, m_s, v_s, row_groups = _shards(p, g, m_s, v_s)
        g = g.to(torch.float32) * clip
        m = _moment_get(m_s)
        v = _moment_get(v_s)
        m = m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v = v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g * g)
        step = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        if ref_ndim >= 2:  # decoupled decay, matrices only
            step.add_(cfg.weight_decay * p.to(torch.float32))
        p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
        _moment_set(m_s, m, row_groups)
        _moment_set(v_s, v, row_groups)

    _zip_map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "count": count}, gnorm
