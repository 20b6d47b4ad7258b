"""Query↔block intersection + fused skip counting (paper Sec 3.3, Eq. 1).

For every block description l and workload conjunct c:

    hits[l, c]  = 1  iff block l may contain records matching conjunct c
    scanned[c]  = Σ_l |block l| · hits[l, c]

The CUDA kernel (``csrc/query_intersect.cu``) computes both in int32/int64
arithmetic; the plain PyTorch version beside it does the same with
broadcast compares.  The wrapper takes the plain version only for tensors
on the CPU.

``leaf`` is the uploaded :func:`repro_torch.engine.plan.pack_leaf_descs`,
``conj`` and ``layout`` the uploaded :func:`repro_torch.kernels.ops.
pack_workload` / :func:`repro_torch.kernels.ops.query_layout`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.route_records import (
    _kernel_device,
    _require,
    _same_device,
)


def query_intersect_plain(
    leaf: dict, conj: dict, layout: dict
) -> tuple[torch.Tensor, torch.Tensor]:
    """(hits (L, C) uint8, scanned (C,) int64) by broadcast compares."""
    nd = layout["num_dims"].long()
    lo = torch.maximum(
        leaf["leaf_lo"][:, None, nd], conj["q_lo"][None, :, nd]
    )
    hi = torch.minimum(
        leaf["leaf_hi"][:, None, nd], conj["q_hi"][None, :, nd]
    )
    ok = (lo < hi).all(dim=2)
    for s, e in layout["segments"]:
        shared = leaf["leaf_cat"][:, None, s:e] & conj["q_cat"][None, :, s:e]
        ok &= (shared != 0).any(dim=2)
    for a in range(int(layout["n_adv"])):
        req_t = conj["q_reqt"][None, :, a] != 0
        req_f = conj["q_reqf"][None, :, a] != 0
        ok &= ~(req_t & (leaf["leaf_advt"][:, None, a] == 0))
        ok &= ~(req_f & (leaf["leaf_advf"][:, None, a] == 0))
    hits = ok.to(torch.uint8)
    scanned = (hits.to(torch.int64) * leaf["size"][:, None]).sum(dim=0)
    return hits, scanned


def query_intersect(
    leaf: dict, conj: dict, layout: dict
) -> tuple[torch.Tensor, torch.Tensor]:
    """(hits (L, C) uint8, scanned (C,) int64) for blocks × conjuncts."""
    lo = leaf["leaf_lo"]
    if not _kernel_device(lo, "query_intersect"):
        return query_intersect_plain(leaf, conj, layout)
    for t in (lo, leaf["leaf_hi"], conj["q_lo"], conj["q_hi"]):
        _require(t, torch.int32, "query_intersect")
    _require(leaf["size"], torch.int64, "query_intersect")
    n_leaves, d = lo.shape
    n_conj = conj["q_lo"].shape[0]
    if conj["q_lo"].shape[1] != d or conj["q_cat"].shape[1] != (
        leaf["leaf_cat"].shape[1]
    ):
        raise ValueError("query_intersect: conjunct and leaf widths differ")
    dev = lo.device
    _same_device(dev, "query_intersect", leaf, conj, layout)
    hits = torch.empty((n_leaves, n_conj), dtype=torch.uint8, device=dev)
    scanned = torch.zeros(n_conj, dtype=torch.int64, device=dev)
    if n_leaves == 0 or n_conj == 0:
        return hits, scanned
    fn = _build.library("query_intersect").query_intersect_launch
    p = _build.ptr
    rc = fn(
        p(lo), p(leaf["leaf_hi"]), p(leaf["leaf_cat"]), p(leaf["leaf_advt"]),
        p(leaf["leaf_advf"]), p(leaf["size"]), n_leaves,
        p(conj["q_lo"]), p(conj["q_hi"]), p(conj["q_cat"]),
        p(conj["q_reqt"]), p(conj["q_reqf"]), n_conj,
        p(layout["num_dims"]), int(layout["num_dims"].shape[0]),
        p(layout["seg_start"]), p(layout["seg_end"]),
        int(layout["seg_start"].shape[0]), d, int(leaf["leaf_cat"].shape[1]),
        int(layout["n_adv"]), int(leaf["leaf_advt"].shape[1]),
        p(hits), p(scanned), _build.stream_ptr(dev),
    )
    _build.check(rc, "query_intersect")
    _build.LAUNCHES["query_intersect"] += 1
    return hits, scanned
