"""Bottom-Up row grouping — Sun et al. [45], the paper's state-of-the-art
baseline (Sec 2.2.2, Sec 7.3).

Pipeline: (1) feature selection from the candidate-cut set via frequency
with subsumption discounting (the paper's configuration: ≤ 15 features;
the BU+ tuning additionally drops features with selectivity > threshold);
(2) records → binary feature vectors, deduplicated with row weights;
(3) greedy bottom-up merging: repeatedly merge the pair of blocks with the
lowest heuristic penalty until every block has ≥ b rows.

The penalty follows Sun et al.'s approximation: a block's scan cost is the
sum of *column weights* (number of queries subsumed) over its set feature
bits; merging i,j costs

    (w_i + w_j)·c(v_i ∨ v_j) − w_i·c(v_i) − w_j·c(v_j).

As the paper notes, this only matches the true objective when feature-
subsumed query sets are disjoint — exactly the weakness qd-tree fixes.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core import predicates as preds
from repro_torch.core import query as qry
from repro_torch.baselines.partitioners import _flat_tree
from repro_torch.core.predicates import CutTable, Schema
from repro_torch.core.qdtree import FrozenQdTree


@dataclasses.dataclass
class BottomUpConfig:
    block_size: int
    max_features: int = 15
    # BU+ (paper Sec 7.5): ignore features with selectivity above this
    selectivity_ceiling: float | None = None
    frequency_floor: int = 1


def _subsumes(cuts: CutTable, wt: qry.WorkloadTensors, schema: Schema):
    """(n_cuts, n_queries) bool: feature f subsumes query q (q ⇒ f)."""
    n_cuts, n_q = cuts.n_cuts, wt.n_queries
    out = np.zeros((n_cuts, wt.n_conjuncts), bool)
    for c in range(n_cuts):
        k = int(cuts.kind[c])
        if k == preds.KIND_RANGE:
            d, cp = int(cuts.dim[c]), int(cuts.cutpoint[c])
            out[c] = wt.q_hi[:, d] <= cp  # conjunct box ⊆ {v < cp}
        elif k == preds.KIND_IN:
            d = int(cuts.dim[c])
            seg = schema.cat_segment(d)
            q_seg = wt.q_cat[:, seg]
            f_seg = cuts.in_mask[c, seg]
            out[c] = (q_seg & ~f_seg[None, :]).sum(axis=1) == 0
        else:
            a = int(cuts.adv_id[c])
            out[c] = wt.q_adv[:, a] == qry.ADV_TRUE
    # a DNF query is subsumed iff every conjunct is
    byq = np.ones((n_cuts, n_q), bool)
    np.logical_and.at(byq, (slice(None), wt.conj_query), out)
    return byq


def select_features(
    cuts: CutTable,
    workload: qry.Workload,
    records: np.ndarray,
    cfg: BottomUpConfig,
) -> np.ndarray:
    """Frequency-based selection with subsumption discounting (Sec 7.3)."""
    wt = workload.tensorize(cuts)
    sub = _subsumes(cuts, wt, workload.schema)  # (n_cuts, n_q)
    freq = sub.sum(axis=1).astype(np.float64)
    if cfg.selectivity_ceiling is not None:  # the BU+ tuning
        M = preds.eval_cuts(records, cuts)
        sel = M.mean(axis=0)
        freq[sel > cfg.selectivity_ceiling] = 0.0
    chosen: list[int] = []
    covered = np.zeros(sub.shape[1], bool)
    live = freq.copy()
    while len(chosen) < cfg.max_features:
        i = int(np.argmax(live))
        if live[i] < cfg.frequency_floor:
            break
        chosen.append(i)
        covered |= sub[i]
        # discount features sharing queries with the chosen one
        overlap = (sub & sub[i][None, :]).sum(axis=1)
        live = live - overlap
        live[i] = -np.inf
    return np.asarray(chosen, np.int64)


def build_bottom_up(
    records: np.ndarray,
    workload: qry.Workload,
    cuts: CutTable,
    cfg: BottomUpConfig,
) -> tuple[FrozenQdTree, np.ndarray]:
    """Returns (layout-as-flat-tree with tightened descriptions, BIDs)."""
    schema = workload.schema
    feats = select_features(cuts, workload, records, cfg)
    wt = workload.tensorize(cuts)
    sub = _subsumes(cuts, wt, schema)[feats]  # (F, n_q)
    colweight = sub.sum(axis=1).astype(np.float64)  # queries subsumed per f

    M = preds.eval_cuts(records, cuts)[:, feats]  # (m, F) feature vectors
    # dedupe to unique vectors with weights
    key = np.packbits(M, axis=1)
    uniq, inv, counts = np.unique(
        key, axis=0, return_inverse=True, return_counts=True
    )
    n_u = uniq.shape[0]
    vecs = np.unpackbits(uniq, axis=1)[:, : M.shape[1]].astype(bool)
    weights = counts.astype(np.int64)

    # greedy merging with a lazy heap over pair penalties
    def cost(v):  # scan cost proxy of a block with OR-vector v
        return float((v * colweight).sum())

    group_vec = [vecs[i].copy() for i in range(n_u)]
    group_w = weights.tolist()
    alive = [True] * n_u
    small = [i for i in range(n_u) if group_w[i] < cfg.block_size]

    heap: list[tuple[float, int, int]] = []

    def push_pairs(i):
        for j in range(len(group_vec)):
            if j != i and alive[j] and (
                group_w[i] < cfg.block_size or group_w[j] < cfg.block_size
            ):
                vi, vj = group_vec[i], group_vec[j]
                pen = (
                    (group_w[i] + group_w[j]) * cost(vi | vj)
                    - group_w[i] * cost(vi)
                    - group_w[j] * cost(vj)
                )
                heapq.heappush(heap, (pen, min(i, j), max(i, j)))

    for i in small:
        push_pairs(i)

    merged_into = list(range(n_u))
    while any(
        alive[i] and group_w[i] < cfg.block_size for i in range(len(alive))
    ):
        if not heap:
            # merge the two smallest alive groups as a fallback
            live = [i for i in range(len(alive)) if alive[i]]
            if len(live) < 2:
                break
            live.sort(key=lambda i: group_w[i])
            i, j = live[0], live[1]
        else:
            pen, i, j = heapq.heappop(heap)
            if not (alive[i] and alive[j]):
                continue
            if (
                group_w[i] >= cfg.block_size
                and group_w[j] >= cfg.block_size
            ):
                continue
        # merge j into i
        group_vec[i] = group_vec[i] | group_vec[j]
        group_w[i] += group_w[j]
        alive[j] = False
        merged_into[j] = i
        if group_w[i] < cfg.block_size:
            push_pairs(i)

    # resolve merge chains → block ids
    def find(i):
        while merged_into[i] != i:
            merged_into[i] = merged_into[merged_into[i]]
            i = merged_into[i]
        return i

    roots = sorted({find(i) for i in range(n_u)})
    bid_of_root = {r: b for b, r in enumerate(roots)}
    uniq_bid = np.array([bid_of_root[find(i)] for i in range(n_u)], np.int32)
    bids = uniq_bid[inv]
    tree = _flat_tree(schema, cuts, len(roots))
    tree.tighten(records, bids)
    return tree, bids
