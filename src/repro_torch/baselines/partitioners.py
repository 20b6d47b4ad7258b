"""Trivial layout baselines from the paper's evaluation (Sec 7.3).

* Random — shuffle records into fixed-size blocks (TPC-H baseline).
* Range  — range-partition on one column, e.g. ingest time (ErrorLog
  default scheme).

Both return the same artifacts as qd-tree layouts (BIDs + per-leaf min-max
descriptions packed into a degenerate FrozenQdTree) so every downstream
metric/benchmark treats all layouts uniformly.  They register as the
``"random"`` / ``"range"`` strategies of ``repro.service.build_layout``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.qdtree import FrozenQdTree
from repro_torch.core.predicates import CutTable, Schema


def _flat_tree(
    schema: Schema, cuts: CutTable, n_blocks: int
) -> FrozenQdTree:
    """A degenerate 'forest of leaves' container for baseline layouts.

    Routing through it is meaningless (baselines assign BIDs directly); it
    exists so tighten()/query intersection/scan benchmarks are shared.  The
    node arrays encode a left-spine comb tree purely for shape validity.
    """
    nn = 2 * n_blocks - 1
    cut_id = np.full(nn, -1, np.int32)
    left = np.full(nn, -1, np.int32)
    right = np.full(nn, -1, np.int32)
    leaf_bid = np.full(nn, -1, np.int32)
    # comb: internal nodes 0..n_blocks-2; leaf i hangs off internal i
    for i in range(n_blocks - 1):
        cut_id[i] = 0
        left[i] = nn - 1 - i  # a leaf
        right[i] = i + 1 if i + 1 < n_blocks - 1 else nn - n_blocks
    for j in range(n_blocks):
        leaf_bid[nn - 1 - j] = j
    bits = max(schema.total_cat_bits, 1)
    return FrozenQdTree(
        schema=schema,
        cuts=cuts,
        cut_id=cut_id,
        left=left,
        right=right,
        leaf_bid=leaf_bid,
        leaf_lo=np.zeros((n_blocks, schema.ndims), np.int32),
        leaf_hi=np.tile(schema.doms, (n_blocks, 1)).astype(np.int32),
        leaf_cat=np.ones((n_blocks, bits), bool),
        leaf_adv=np.ones((n_blocks, cuts.n_adv, 2), bool),
        depth=max(n_blocks - 1, 1),
    )


def random_layout(
    records: np.ndarray,
    schema: Schema,
    cuts: CutTable,
    block_size: int,
    seed: int = 0,
) -> tuple[FrozenQdTree, np.ndarray]:
    """Random shuffler: fixed-size blocks, arrival-order agnostic."""
    rng = np.random.default_rng(seed)
    m = records.shape[0]
    n_blocks = max(1, m // block_size)
    bids = rng.permutation(m) % n_blocks
    tree = _flat_tree(schema, cuts, n_blocks)
    tree.tighten(records, bids.astype(np.int32))
    return tree, bids.astype(np.int32)


def range_layout(
    records: np.ndarray,
    schema: Schema,
    cuts: CutTable,
    block_size: int,
    column: int,
) -> tuple[FrozenQdTree, np.ndarray]:
    """Range partitioning on ``column`` (e.g. ingest time)."""
    m = records.shape[0]
    n_blocks = max(1, m // block_size)
    order = np.argsort(records[:, column], kind="stable")
    bids = np.empty(m, np.int32)
    bids[order] = (np.arange(m) * n_blocks) // m
    tree = _flat_tree(schema, cuts, n_blocks)
    tree.tighten(records, bids)
    return tree, bids
