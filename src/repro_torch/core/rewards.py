"""Skipping metrics: C(P), scanned fraction, and per-node rewards.

Implements paper Eq. 1 and Sec 5.2.2.  ``C(P_i) = |P_i| · Σ_q S(P_i, q)``
where S is the min-max/description-based skip indicator.  The scanned
fraction reported in Table 2 is ``Σ_q Σ_{P ∩ q} |P| / (|V|·|W|)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import query as qry
from repro_torch.core.qdtree import FrozenQdTree, Node, QdTree


@dataclasses.dataclass
class SkipStats:
    n_records: int
    n_queries: int
    n_blocks: int
    scanned_tuples: int  # Σ_q Σ_{P ∩ q} |P|
    skipped_tuples: int  # C(P)
    block_sizes: np.ndarray
    query_hits: np.ndarray  # (n_blocks, n_queries) bool
    # (n_conjuncts,) int64 Σ_{P ∩ c} |P| per workload conjunct, as the
    # query kernel reduces it
    conj_scanned: Optional[np.ndarray] = None

    @property
    def scanned_fraction(self) -> float:
        denom = self.n_records * self.n_queries
        return float(self.scanned_tuples) / denom if denom else 0.0

    @property
    def skipped_fraction(self) -> float:
        return 1.0 - self.scanned_fraction


def block_query_hits(
    tree: FrozenQdTree, wt: qry.WorkloadTensors
) -> np.ndarray:
    """(n_leaves, n_queries) bool — which blocks each query must scan."""
    conj = qry.conjuncts_intersect(
        tree.leaf_lo, tree.leaf_hi, tree.leaf_cat, tree.leaf_adv, wt,
        tree.schema,
    )
    return qry.queries_intersect(conj, wt)


def evaluate_layout(
    tree: FrozenQdTree,
    records: np.ndarray,
    workload: qry.Workload,
    tighten: bool = True,
    backend: Optional[str] = None,
    device=None,
) -> SkipStats:
    """Route ``records`` through ``tree`` and score the resulting layout.

    Thin wrapper over ``LayoutEngine.skip_stats``, on the engine's own
    backend unless ``backend`` names another (``"numpy"``: the host
    oracle).  ``device`` places the tree's attached engine when this call
    creates it (None: the GPU).
    """
    from repro_torch.engine import engine_for

    return engine_for(tree, device=device).skip_stats(
        records, workload, tighten=tighten, backend=backend
    )


def selectivity_lower_bound(
    records: np.ndarray, workload: qry.Workload
) -> float:
    """True workload selectivity — the paper's lower bound for any layout."""
    total = 0
    for q in workload.queries:
        total += int(q.evaluate(records, workload.schema).sum())
    return total / (records.shape[0] * len(workload))


# ---------------------------------------------------------------------------
# Per-node rewards for WOODBLOCK (paper Sec 5.2.2)
# ---------------------------------------------------------------------------
def per_node_rewards(
    tree: QdTree,
    sample: np.ndarray,
    wt: qry.WorkloadTensors,
    tighten: bool = True,
) -> tuple[dict[int, float], float]:
    """Compute R((n, p)) = S(n) / (|W| · |n.records|) for every internal node.

    S(n) is the number of (record, query) skips summed over the leaves below
    n, computed on the construction sample.  Returns ({id(node): reward},
    whole-tree scanned fraction on the sample).
    """
    frozen = tree.freeze()
    leaves = tree.leaves()
    sizes = np.array([n.size for n in leaves], np.int64)
    if tighten:
        bids = np.full(sample.shape[0], -1, np.int32)
        for n in leaves:
            if n.rows is not None:
                bids[n.rows] = n.bid
        keep = bids >= 0
        frozen.tighten(sample[keep], bids[keep])
    hits = block_query_hits(frozen, wt)  # (n_leaves, n_q)
    n_q = hits.shape[1]
    skipped_per_leaf = sizes * (n_q - hits.sum(axis=1))  # C per leaf

    # bottom-up accumulate S(n)
    s_of: dict[int, int] = {}

    def _acc(n: Node) -> int:
        if n.is_leaf:
            s = int(skipped_per_leaf[n.bid])
        else:
            s = _acc(n.left) + _acc(n.right)
        s_of[id(n)] = s
        return s

    _acc(tree.root)
    rewards: dict[int, float] = {}
    for n in tree.nodes():
        if not n.is_leaf and n.size > 0:
            rewards[id(n)] = s_of[id(n)] / (n_q * n.size)
    total = sample.shape[0] * n_q
    scanned_frac = 1.0 - s_of[id(tree.root)] / total if total else 0.0
    return rewards, scanned_frac
