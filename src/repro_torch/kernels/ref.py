"""Numpy oracle for the fused ingestion path, and the partial converter.

``fused_ingest_ref`` is the bit-identity oracle: route via the numpy
descent, tighten via the ``IncrementalTightener`` arithmetic, packaged as
the ``(bids, TightenPartial)`` pair every fused backend returns.
``partial_from_fused`` turns the int32 aggregates of ``fused_ingest``
(kernel or plain version) into that exchange format.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.qdtree import (
    FrozenQdTree,
    IncrementalTightener,
    TightenPartial,
)


def fused_ingest_ref(tree: FrozenQdTree, records: np.ndarray):
    """Numpy bit-identity oracle: one batch routed + reduced per leaf.

    Exactly the two-pass arithmetic (``FrozenQdTree.route`` then
    ``IncrementalTightener.update``), returned in the fused-path shape:
    ``(bids int32, TightenPartial)``.
    """
    bids = tree.route(records)
    t = IncrementalTightener(tree)
    t.update(records, bids)
    return bids, t.as_partial()


def partial_from_fused(tree: FrozenQdTree, out) -> TightenPartial:
    """Convert ``fused_ingest`` aggregates into the tightener's format.

    ``out`` is a :class:`~repro_torch.kernels.fused_ingest.FusedOut`
    (tensors on any device).  Empty leaves get the tightener's int64
    identity elements and ``hi`` becomes exclusive (max + 1) — bit-identical
    to ``IncrementalTightener.update`` over the same records.
    """
    i64 = np.iinfo(np.int64)
    counts = out.counts.cpu().numpy().astype(np.int64)
    ne = counts > 0
    lo = np.where(ne[:, None], out.lo.cpu().numpy().astype(np.int64), i64.max)
    hi = np.where(
        ne[:, None], out.hi.cpu().numpy().astype(np.int64) + 1, i64.min
    )
    cat = out.cat.cpu().numpy().astype(bool) & ne[:, None]
    adv = np.zeros_like(tree.leaf_adv)
    na = tree.cuts.n_adv
    if na:
        adv[:, :, 0] = out.advt[:, :na].cpu().numpy().astype(bool)
        adv[:, :, 1] = out.advf[:, :na].cpu().numpy().astype(bool)
        adv &= ne[:, None, None]
    return TightenPartial(counts=counts, lo=lo, hi=hi, cat=cat, adv=adv)
