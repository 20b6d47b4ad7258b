"""Skipping metrics: C(P) and the scanned fraction.

Implements paper Eq. 1.  ``C(P_i) = |P_i| · Σ_q S(P_i, q)`` where S is the
min-max/description-based skip indicator.  The scanned fraction reported
in Table 2 is ``Σ_q Σ_{P ∩ q} |P| / (|V|·|W|)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import query as qry
from repro_torch.core.qdtree import FrozenQdTree


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
    backend: str = "numpy",
    device=None,
) -> SkipStats:
    """Route ``records`` through ``tree`` and score the resulting layout.

    Thin wrapper over ``LayoutEngine.skip_stats``.  ``device`` places the
    tree's attached engine when this call creates it (None: the GPU).
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
