"""Query↔block intersection + fused skip counting (paper Sec 3.3, Eq. 1).

For every block description l and workload conjunct c:

    hits[l, c]  = 1  iff block l may contain records matching conjunct c
    scanned[c]  = Σ_l |block l| · hits[l, c]

Both come from one launch of the CUDA kernel (``csrc/query_intersect.cu``)
in int32/int64 arithmetic; the plain PyTorch version beside it computes
the same from the same packed operands with broadcast compares and word
ANDs.  The wrapper takes the plain version only for tensors on the CPU.

``leaf`` is the uploaded :func:`repro_torch.engine.plan.pack_leaf_descs`,
``conj`` and ``layout`` the uploaded :func:`repro_torch.kernels.ops.
pack_workload` / :func:`repro_torch.kernels.ops.query_layout`: one int32
row per leaf and per conjunct, the categorical and advanced-cut bits 32
to a word.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.route_records import (
    _kernel_device,
    _require,
    _same_device,
)


def _widths(layout: dict) -> tuple[int, int, int, int]:
    """(numeric columns, segment entries, cat words, adv words)."""
    return (int(layout["num_dims"].shape[0]), int(layout["seg_word"].shape[0]),
            int(layout["cw"]), int(layout["aw"]))


def query_intersect_plain(
    leaf: dict, conj: dict, layout: dict
) -> tuple[torch.Tensor, torch.Tensor]:
    """(hits (L, C) uint8, scanned (C,) int64) by broadcast compares."""
    n, E, cw, aw = _widths(layout)
    ld, cd = leaf["desc"], conj["desc"]
    lo = torch.maximum(ld[:, None, :n], cd[None, :, :n])
    hi = torch.minimum(ld[:, None, n:2 * n], cd[None, :, n:2 * n])
    ok = (lo < hi).all(dim=2)
    lcat = ld[:, 2 * n:2 * n + cw][:, layout["seg_word"].long()]
    common = lcat[:, None, :] & cd[None, :, 2 * n:2 * n + E]  # (L, C, E)
    for s, e in layout["seg_ranges"]:
        ok &= (common[:, :, s:e] != 0).any(dim=2)
    seen_t = ld[:, None, 2 * n + cw:2 * n + cw + aw]
    seen_f = ld[:, None, 2 * n + cw + aw:]
    req_t = cd[None, :, 2 * n + E:2 * n + E + aw]
    req_f = cd[None, :, 2 * n + E + aw:]
    ok &= (((req_t & ~seen_t) | (req_f & ~seen_f)) == 0).all(dim=2)
    hits = ok.to(torch.uint8)
    scanned = (hits.to(torch.int64) * leaf["size"][:, None]).sum(dim=0)
    return hits, scanned


def query_intersect(
    leaf: dict, conj: dict, layout: dict
) -> tuple[torch.Tensor, torch.Tensor]:
    """(hits (L, C) uint8, scanned (C,) int64) for blocks × conjuncts."""
    ld, cd = leaf["desc"], conj["desc"]
    if not _kernel_device(ld, "query_intersect"):
        return query_intersect_plain(leaf, conj, layout)
    n, E, cw, aw = _widths(layout)
    _require(ld, torch.int32, "query_intersect")
    _require(cd, torch.int32, "query_intersect")
    _require(leaf["size"], torch.int64, "query_intersect")
    if ld.shape[1] != 2 * n + cw + 2 * aw or cd.shape[1] != 2 * n + E + 2 * aw:
        raise ValueError("query_intersect: rows do not match the layout")
    dev = ld.device
    _same_device(dev, "query_intersect", leaf, conj, layout)
    n_leaves, n_conj = ld.shape[0], cd.shape[0]
    hits = torch.empty((n_leaves, n_conj), dtype=torch.uint8, device=dev)
    if n_leaves == 0 or n_conj == 0:
        return hits, torch.zeros(n_conj, dtype=torch.int64, device=dev)
    scanned = torch.empty(n_conj, dtype=torch.int64, device=dev)
    p = _build.ptr
    rc = _build.library("query_intersect").query_intersect_launch(
        p(ld), p(leaf["size"]), n_leaves, p(cd), n_conj,
        p(layout["seg_word"]), p(layout["seg_end"]), n,
        int(layout["seg_end"].shape[0]), E, cw, aw, p(hits), p(scanned),
        _build.stream_ptr(dev),
    )
    _build.check(rc, "query_intersect")
    _build.LAUNCHES["query_intersect"] += 1
    return hits, scanned
