"""Fused single-pass ingestion: route + per-leaf tightening aggregates.

The two-pass path reads every record twice — once to route it
(``eval_cuts`` → ``locate_leaf``, paper Sec 3.1) and once to min-max-
tighten its destination leaf's description (``IncrementalTightener``,
Sec 3.2).  ``fused_ingest`` does both in one pass over the batch: the
CUDA kernel (``csrc/fused_ingest.cu``) descends each record's root path
and folds it into int32 per-leaf accumulators with atomics.  The plain
PyTorch version beside it evaluates the full predicate matrix, locates
leaves in path-constraint form and reduces with scatters; the wrapper
takes it only for a tensor on the CPU.

Every row of the batch is a real record: the port never pads a batch,
so there is no validity mask.  ``lo``/``hi`` of a leaf no record reached
keep the int32 identities, ``hi`` is the column maximum (not max + 1);
``kernels/ref.partial_from_fused`` turns the outputs into the
tightener's exchange format.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.routing import adv_truth
from repro_torch.kernels import _build
from repro_torch.kernels.route_records import (
    _kernel_device,
    _require_records,
    eval_cuts_plain,
    locate_leaf_plain,
)

I32_MAX = 2**31 - 1
I32_MIN = -(2**31)


class FusedOut(NamedTuple):
    bids: torch.Tensor  # (m,) int32
    counts: torch.Tensor  # (L,) int32 records per leaf
    lo: torch.Tensor  # (L, D) int32 column minima (I32_MAX where empty)
    hi: torch.Tensor  # (L, D) int32 column maxima (I32_MIN where empty)
    cat: torch.Tensor  # (L, bits) uint8 categorical values present
    advt: torch.Tensor  # (L, max(n_adv, 1)) uint8 adv cut seen true
    advf: torch.Tensor  # (L, max(n_adv, 1)) uint8 adv cut seen false


def _empty_aggregates(records: torch.Tensor, ops: dict) -> list:
    L, d, dev = int(ops["n_leaves"]), records.shape[1], records.device
    a3 = int(ops["adv"].shape[0])
    return [
        torch.zeros(L, dtype=torch.int32, device=dev),
        torch.full((L, d), I32_MAX, dtype=torch.int32, device=dev),
        torch.full((L, d), I32_MIN, dtype=torch.int32, device=dev),
        torch.zeros((L, int(ops["bits"])), dtype=torch.uint8, device=dev),
        torch.zeros((L, a3), dtype=torch.uint8, device=dev),
        torch.zeros((L, a3), dtype=torch.uint8, device=dev),
    ]


def fused_ingest_plain(records: torch.Tensor, ops: dict) -> FusedOut:
    """Route (full predicate matrix, path-constraint form) + scatters."""
    bids = locate_leaf_plain(eval_cuts_plain(records, ops), ops)
    counts, lo, hi, cat, advt, advf = _empty_aggregates(records, ops)
    b = bids.long()
    counts += torch.bincount(b, minlength=counts.shape[0]).to(torch.int32)
    idx = b[:, None].expand(-1, records.shape[1])
    lo.scatter_reduce_(0, idx, records, "amin")
    hi.scatter_reduce_(0, idx, records, "amax")
    cat_dims = ops["cat_dims"].long()
    if cat_dims.numel():
        pos = (records[:, cat_dims] + ops["cat_off"][cat_dims][None, :])
        pos = pos.clamp_(0, cat.shape[1] - 1).long()
        cat[b[:, None].expand_as(pos), pos] = 1
    n_adv = int(ops["n_adv"])
    if n_adv:
        t = adv_truth(records, ops["adv"])[:, :n_adv]
        for flags, truth in ((advt, t), (advf, ~t)):
            rows, cols = truth.nonzero(as_tuple=True)
            flags[b[rows], cols] = 1
    return FusedOut(bids, counts, lo, hi, cat, advt, advf)


def fused_ingest(records: torch.Tensor, ops: dict) -> FusedOut:
    """One fused pass: block ids plus per-leaf aggregates of the batch."""
    if not _kernel_device(records, "fused_ingest"):
        return fused_ingest_plain(records, ops)
    _require_records(records, ops, "fused_ingest")
    m, d = records.shape
    bids = torch.empty(m, dtype=torch.int32, device=records.device)
    aggs = _empty_aggregates(records, ops)
    if m == 0:
        return FusedOut(bids, *aggs)
    counts, lo, hi, cat, advt, advf = aggs
    fn = _build.library("fused_ingest").fused_ingest_launch
    p = _build.ptr
    rc = fn(
        p(records), m, d,
        p(ops["kind"]), p(ops["dim"]), p(ops["cutpoint"]), p(ops["in_mask"]),
        int(ops["kind"].shape[0]), int(ops["bits"]), p(ops["cat_off"]),
        p(ops["adv"]), p(ops["adv_id"]),
        p(ops["cut_id"]), p(ops["left"]), p(ops["right"]),
        p(ops["leaf_bid"]), int(ops["depth"]),
        p(ops["cat_dims"]), int(ops["cat_dims"].shape[0]), int(ops["n_adv"]),
        p(bids), p(counts), p(lo), p(hi), p(cat), p(advt), p(advf),
        int(advt.shape[1]),
        _build.stream_ptr(records.device),
    )
    _build.check(rc, "fused_ingest")
    _build.LAUNCHES["fused_ingest"] += 1
    return FusedOut(bids, counts, lo, hi, cat, advt, advf)
