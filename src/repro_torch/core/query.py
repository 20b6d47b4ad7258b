"""Queries, workloads, and query↔block intersection (paper Sec 3.3).

A query is a DNF over atomic predicates:

  * numeric range atoms  (dim, op, literal)          op ∈ {<, <=, >, >=, ==}
  * categorical atoms    (dim, IN, values)
  * advanced atoms       (adv_id, polarity)          paper Sec 6.1

Each *conjunct* tensorizes to the same shape as a node description —
(q_lo, q_hi, q_cat, q_adv_req) — so intersection is a dense elementwise
check, which is what the ``query_intersect`` CUDA kernel computes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import predicates as preds
from repro_torch.core.predicates import CutTable, CutTableBuilder, Schema

ADV_ANY, ADV_TRUE, ADV_FALSE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class RangeAtom:
    dim: int
    op: int  # OP_LT/LE/GT/GE/EQ
    literal: int


@dataclasses.dataclass(frozen=True)
class InAtom:
    dim: int
    values: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class AdvAtom:
    col_a: int
    op: int
    col_b: int
    polarity: bool = True  # False means the query requires NOT(pred)


Atom = RangeAtom | InAtom | AdvAtom


@dataclasses.dataclass(frozen=True)
class Query:
    """DNF: OR over conjuncts; each conjunct is an AND over atoms."""

    conjuncts: tuple[tuple[Atom, ...], ...]

    @staticmethod
    def conjunction(atoms: Sequence[Atom]) -> "Query":
        return Query(conjuncts=(tuple(atoms),))

    @staticmethod
    def disjunction(conjuncts: Sequence[Sequence[Atom]]) -> "Query":
        return Query(conjuncts=tuple(tuple(c) for c in conjuncts))

    def evaluate(self, records: np.ndarray, schema: Schema) -> np.ndarray:
        """Exact per-record truth (m,) bool — ground truth for selectivity."""
        out = np.zeros(records.shape[0], dtype=bool)
        for conj in self.conjuncts:
            acc = np.ones(records.shape[0], dtype=bool)
            for a in conj:
                if isinstance(a, RangeAtom):
                    acc &= preds._OP_FNS[a.op](records[:, a.dim], a.literal)
                elif isinstance(a, InAtom):
                    acc &= np.isin(records[:, a.dim], np.asarray(a.values))
                else:
                    t = preds.AdvPredicate(a.col_a, a.op, a.col_b).evaluate(
                        records
                    )
                    acc &= t if a.polarity else ~t
            out |= acc
        return out


@dataclasses.dataclass
class WorkloadTensors:
    """Stacked conjunct descriptions for a whole workload.

    q_lo, q_hi  : (n_conj, ndims) int32 — numeric box (hi exclusive)
    q_cat       : (n_conj, bits) bool   — allowed categorical values
    q_adv       : (n_conj, n_adv) int8  — ADV_ANY / ADV_TRUE / ADV_FALSE
    conj_query  : (n_conj,) int32       — owning query index
    n_queries   : int
    """

    q_lo: np.ndarray
    q_hi: np.ndarray
    q_cat: np.ndarray
    q_adv: np.ndarray
    conj_query: np.ndarray
    n_queries: int

    @property
    def n_conjuncts(self) -> int:
        return int(self.q_lo.shape[0])


@dataclasses.dataclass
class Workload:
    schema: Schema
    queries: tuple[Query, ...]

    def __len__(self) -> int:
        return len(self.queries)

    # -- candidate cuts (paper Sec 3.4: all pushed-down unary predicates) ---
    def candidate_cuts(self, max_adv: int | None = None) -> CutTable:
        b = CutTableBuilder(self.schema)
        n_adv = 0
        for q in self.queries:
            for conj in q.conjuncts:
                for a in conj:
                    if isinstance(a, RangeAtom):
                        b.add_range(a.dim, a.op, a.literal)
                    elif isinstance(a, InAtom):
                        b.add_in(a.dim, a.values)
                    else:
                        if max_adv is None or n_adv < max_adv:
                            b.add_adv(a.col_a, a.op, a.col_b)
                            n_adv += 1
        return b.build()

    # -- tensorization -------------------------------------------------------
    def tensorize(self, cuts: CutTable) -> WorkloadTensors:
        schema = self.schema
        doms = schema.doms
        bits = max(schema.total_cat_bits, 1)
        n_adv = cuts.n_adv
        adv_index = {
            (a.col_a, a.op, a.col_b): i for i, a in enumerate(cuts.adv)
        }
        rows_lo, rows_hi, rows_cat, rows_adv, owner = [], [], [], [], []
        for qi, q in enumerate(self.queries):
            for conj in q.conjuncts:
                lo = np.zeros(schema.ndims, np.int64)
                hi = doms.astype(np.int64).copy()
                cat = np.ones(bits, bool)
                adv = np.zeros(max(n_adv, 1), np.int8)
                for a in conj:
                    if isinstance(a, RangeAtom):
                        if a.op == preds.OP_LT:
                            hi[a.dim] = min(hi[a.dim], a.literal)
                        elif a.op == preds.OP_LE:
                            hi[a.dim] = min(hi[a.dim], a.literal + 1)
                        elif a.op == preds.OP_GT:
                            lo[a.dim] = max(lo[a.dim], a.literal + 1)
                        elif a.op == preds.OP_GE:
                            lo[a.dim] = max(lo[a.dim], a.literal)
                        elif a.op == preds.OP_EQ:
                            lo[a.dim] = max(lo[a.dim], a.literal)
                            hi[a.dim] = min(hi[a.dim], a.literal + 1)
                        else:
                            raise ValueError("OP_NE atoms unsupported")
                    elif isinstance(a, InAtom):
                        seg = schema.cat_segment(a.dim)
                        m = np.zeros(seg.stop - seg.start, bool)
                        m[np.asarray(a.values, np.int64)] = True
                        cat[seg] &= m
                    else:
                        key = (a.col_a, a.op, a.col_b)
                        if key in adv_index:
                            adv[adv_index[key]] = (
                                ADV_TRUE if a.polarity else ADV_FALSE
                            )
                        # adv atoms outside the cut table cannot prune blocks
                        # (no metadata for them) — drop, which is conservative.
                rows_lo.append(lo)
                rows_hi.append(hi)
                rows_cat.append(cat)
                rows_adv.append(adv)
                owner.append(qi)
        return WorkloadTensors(
            q_lo=np.asarray(rows_lo, np.int32),
            q_hi=np.asarray(rows_hi, np.int32),
            q_cat=np.asarray(rows_cat, bool),
            q_adv=np.asarray(rows_adv, np.int8),
            conj_query=np.asarray(owner, np.int32),
            n_queries=len(self.queries),
        )


# ---------------------------------------------------------------------------
# Intersection checks (numpy reference; kernel in kernels/query_intersect.py)
# ---------------------------------------------------------------------------
def conjuncts_intersect(
    desc_lo: np.ndarray,  # (L, ndims)
    desc_hi: np.ndarray,
    desc_cat: np.ndarray,  # (L, bits)
    desc_adv: np.ndarray,  # (L, n_adv, 2)
    wt: WorkloadTensors,
    schema: Schema,
) -> np.ndarray:
    """(L, n_conj) bool — does block description L possibly contain records
    matching conjunct c?  Conservative (never false-negative)."""
    # numeric box overlap on every numeric dim: max(lo) < min(hi)
    lo = np.maximum(desc_lo[:, None, :], wt.q_lo[None, :, :])
    hi = np.minimum(desc_hi[:, None, :], wt.q_hi[None, :, :])
    numeric = ~schema.is_categorical
    box_ok = (lo < hi)[:, :, numeric].all(axis=2)
    # categorical: every constrained dim must share at least one value
    cat_ok = np.ones(box_ok.shape, bool)
    off = schema.cat_offsets
    for d in np.nonzero(schema.is_categorical)[0]:
        seg = slice(int(off[d]), int(off[d]) + schema.columns[d].dom)
        inter = (
            desc_cat[:, None, seg] & wt.q_cat[None, :, seg]
        ).any(axis=2)
        cat_ok &= inter
    # advanced bits: required polarity must be possible under the block
    adv_ok = np.ones(box_ok.shape, bool)
    n_adv = desc_adv.shape[1]
    for a in range(n_adv):
        req = wt.q_adv[:, a]  # (n_conj,)
        may_t = desc_adv[:, a, 0]  # (L,)
        may_f = desc_adv[:, a, 1]
        ok = np.ones((desc_adv.shape[0], req.shape[0]), bool)
        ok &= ~((req == ADV_TRUE)[None, :] & ~may_t[:, None])
        ok &= ~((req == ADV_FALSE)[None, :] & ~may_f[:, None])
        adv_ok &= ok
    return box_ok & cat_ok & adv_ok


def queries_intersect(
    conj_hits: np.ndarray, wt: WorkloadTensors
) -> np.ndarray:
    """Reduce conjunct hits to per-query hits: (L, n_conj) → (L, n_queries).

    A DNF query touches a block iff ANY of its conjuncts does.
    """
    L = conj_hits.shape[0]
    out = np.zeros((L, wt.n_queries), bool)
    np.logical_or.at(out, (slice(None), wt.conj_query), conj_hits)
    return out


def route_query(
    tree, query: Query, device=None  # tree: FrozenQdTree (avoid import cycle)
) -> np.ndarray:
    """BID IN (...) list for one query (paper Sec 3.3) — compatibility shim.

    Delegates to the tree's attached engine so there is a single
    ``route_query`` implementation (``LayoutEngine.route_query``, itself a
    1-query :meth:`~repro_torch.engine.LayoutEngine.route_queries`).
    ``device`` places a newly attached engine (None: the GPU).
    """
    from repro_torch.engine import engine_for

    return engine_for(tree, device=device).route_query(query)
