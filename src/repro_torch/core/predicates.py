"""Schema, cuts, and vectorized predicate evaluation for qd-trees.

Everything is dictionary-encoded to int32 up front (the paper encodes
literals; we encode whole columns — see DESIGN.md §3).  A *cut* is one of:

  * range cut   — canonical form ``row[dim] < cutpoint`` (all of <, <=, >, >=
                  from the workload canonicalize to a cutpoint; which side is
                  "left" is immaterial to the tree),
  * IN cut      — ``row[dim] ∈ S`` for a categorical dim, stored as a bit
                  mask over the concatenated categorical bit space,
  * advanced cut— ``row[col_a] op row[col_b]`` (paper Sec 6.1), indexed into
                  a small advanced-predicate table.

The candidate-cut set is shared by every tree node (paper Sec 3.4), which is
what lets routing factorize into "evaluate all cuts once per record" +
"descend by selecting bits" — the formulation the route kernels use.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Cut kinds.
KIND_RANGE = 0
KIND_IN = 1
KIND_ADV = 2

# Comparison ops for advanced (column-vs-column) predicates and query atoms.
OP_LT, OP_LE, OP_GT, OP_GE, OP_EQ, OP_NE = 0, 1, 2, 3, 4, 5

_OP_FNS = {
    OP_LT: lambda a, b: a < b,
    OP_LE: lambda a, b: a <= b,
    OP_GT: lambda a, b: a > b,
    OP_GE: lambda a, b: a >= b,
    OP_EQ: lambda a, b: a == b,
    OP_NE: lambda a, b: a != b,
}

KIND_NUMERIC = "numeric"
KIND_CATEGORICAL = "categorical"


@dataclasses.dataclass(frozen=True)
class Column:
    name: str
    kind: str  # "numeric" | "categorical"
    dom: int  # values live in [0, dom)

    def __post_init__(self):
        if self.kind not in (KIND_NUMERIC, KIND_CATEGORICAL):
            raise ValueError(f"bad column kind {self.kind!r}")
        if self.dom <= 0:
            raise ValueError(f"column {self.name}: dom must be positive")


@dataclasses.dataclass(frozen=True)
class Schema:
    """An ordered set of dictionary-encoded columns."""

    columns: tuple[Column, ...]

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError("duplicate column names")

    # -- lookups ---------------------------------------------------------
    @property
    def ndims(self) -> int:
        return len(self.columns)

    def dim(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(name)

    @property
    def doms(self) -> np.ndarray:
        return np.array([c.dom for c in self.columns], dtype=np.int32)

    @property
    def is_categorical(self) -> np.ndarray:
        return np.array(
            [c.kind == KIND_CATEGORICAL for c in self.columns], dtype=bool
        )

    # -- categorical bit space -------------------------------------------
    # All categorical domains are concatenated into one bit space so a node's
    # categorical mask is a single vector (fast to AND / intersect).
    @property
    def cat_offsets(self) -> np.ndarray:
        """Per-dim offset into the concatenated categorical bit space.

        -1 for numeric dims.
        """
        off = np.full(self.ndims, -1, dtype=np.int32)
        pos = 0
        for i, c in enumerate(self.columns):
            if c.kind == KIND_CATEGORICAL:
                off[i] = pos
                pos += c.dom
        return off

    @property
    def total_cat_bits(self) -> int:
        return int(
            sum(c.dom for c in self.columns if c.kind == KIND_CATEGORICAL)
        )

    def cat_segment(self, dim: int) -> slice:
        off = self.cat_offsets[dim]
        if off < 0:
            raise ValueError(f"dim {dim} is not categorical")
        return slice(int(off), int(off) + self.columns[dim].dom)

    def validate_records(self, records: np.ndarray) -> None:
        if records.ndim != 2 or records.shape[1] != self.ndims:
            raise ValueError(
                f"records shape {records.shape} != (*, {self.ndims})"
            )
        lo_ok = (records >= 0).all()
        hi_ok = (records < self.doms[None, :]).all()
        if not (lo_ok and hi_ok):
            raise ValueError("records out of declared domains")


@dataclasses.dataclass(frozen=True)
class AdvPredicate:
    """Binary predicate ``col_a op col_b`` (paper Sec 6.1)."""

    col_a: int
    op: int
    col_b: int

    def evaluate(self, records: np.ndarray) -> np.ndarray:
        return _OP_FNS[self.op](records[:, self.col_a], records[:, self.col_b])


@dataclasses.dataclass
class CutTable:
    """The shared candidate-cut set, in struct-of-arrays form.

    ``kind``      (n,)  int32   one of KIND_*
    ``dim``       (n,)  int32   column index (range/IN cuts; -1 for adv)
    ``cutpoint``  (n,)  int32   canonical ``row[dim] < cutpoint`` (range only)
    ``in_mask``   (n, total_cat_bits) bool   membership mask (IN only;
                  bits outside the cut's dim segment are zero)
    ``adv_id``    (n,)  int32   index into ``adv`` (adv cuts only, else -1)
    ``adv``       tuple[AdvPredicate, ...]
    """

    schema: Schema
    kind: np.ndarray
    dim: np.ndarray
    cutpoint: np.ndarray
    in_mask: np.ndarray
    adv_id: np.ndarray
    adv: tuple[AdvPredicate, ...]

    @property
    def n_cuts(self) -> int:
        return int(self.kind.shape[0])

    @property
    def n_adv(self) -> int:
        return len(self.adv)

    def describe(self, c: int) -> str:
        k = int(self.kind[c])
        if k == KIND_RANGE:
            name = self.schema.columns[int(self.dim[c])].name
            return f"{name} < {int(self.cutpoint[c])}"
        if k == KIND_IN:
            d = int(self.dim[c])
            seg = self.schema.cat_segment(d)
            vals = np.nonzero(self.in_mask[c, seg])[0]
            return f"{self.schema.columns[d].name} IN {vals.tolist()}"
        a = self.adv[int(self.adv_id[c])]
        opn = {0: "<", 1: "<=", 2: ">", 3: ">=", 4: "==", 5: "!="}[a.op]
        return (
            f"{self.schema.columns[a.col_a].name} {opn} "
            f"{self.schema.columns[a.col_b].name}"
        )


class CutTableBuilder:
    """Accumulates candidate cuts (with dedup) from a workload."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self._range: dict[tuple[int, int], None] = {}
        self._in: dict[tuple[int, bytes], np.ndarray] = {}
        self._adv: dict[tuple[int, int, int], int] = {}
        self._adv_list: list[AdvPredicate] = []

    # -- adders ------------------------------------------------------------
    def add_range(self, dim: int, op: int, literal: int) -> None:
        """Add the cut(s) induced by a numeric atom ``row[dim] op literal``.

        Canonicalized to split points of the form ``row[dim] < c``.
        """
        col = self.schema.columns[dim]
        if col.kind != KIND_NUMERIC:
            raise ValueError(f"range cut on categorical column {col.name}")
        if op == OP_LT:
            points = [literal]
        elif op == OP_LE:
            points = [literal + 1]
        elif op == OP_GT:
            points = [literal + 1]
        elif op == OP_GE:
            points = [literal]
        elif op == OP_EQ:
            points = [literal, literal + 1]  # isolates [v, v+1)
        else:
            raise ValueError(f"unsupported range op {op}")
        for c in points:
            if 0 < c < col.dom:  # trivial cuts split nothing
                self._range.setdefault((dim, int(c)), None)

    def add_in(self, dim: int, values: Sequence[int]) -> None:
        col = self.schema.columns[dim]
        if col.kind != KIND_CATEGORICAL:
            raise ValueError(f"IN cut on numeric column {col.name}")
        mask = np.zeros(self.schema.total_cat_bits, dtype=bool)
        seg = self.schema.cat_segment(dim)
        vals = np.asarray(sorted(set(int(v) for v in values)), dtype=np.int64)
        if (vals < 0).any() or (vals >= col.dom).any():
            raise ValueError(f"IN values out of domain for {col.name}")
        mask[seg.start + vals] = True
        if mask[seg].all() or not mask[seg].any():
            return  # trivial
        self._in.setdefault((dim, mask.tobytes()), mask)

    def add_adv(self, col_a: int, op: int, col_b: int) -> int:
        key = (col_a, op, col_b)
        if key not in self._adv:
            self._adv[key] = len(self._adv_list)
            self._adv_list.append(AdvPredicate(col_a, op, col_b))
        return self._adv[key]

    # -- finalize ------------------------------------------------------------
    def build(self) -> CutTable:
        n = len(self._range) + len(self._in) + len(self._adv_list)
        bits = self.schema.total_cat_bits
        kind = np.zeros(n, np.int32)
        dim = np.full(n, -1, np.int32)
        cutpoint = np.zeros(n, np.int32)
        in_mask = np.zeros((n, max(bits, 1)), bool)
        adv_id = np.full(n, -1, np.int32)
        i = 0
        for (d, c) in sorted(self._range):
            kind[i], dim[i], cutpoint[i] = KIND_RANGE, d, c
            i += 1
        for (d, _), mask in sorted(self._in.items(), key=lambda kv: kv[0]):
            kind[i], dim[i] = KIND_IN, d
            in_mask[i, :bits] = mask
            i += 1
        for j in range(len(self._adv_list)):
            kind[i], adv_id[i] = KIND_ADV, j
            i += 1
        return CutTable(
            schema=self.schema,
            kind=kind,
            dim=dim,
            cutpoint=cutpoint,
            in_mask=in_mask,
            adv_id=adv_id,
            adv=tuple(self._adv_list),
        )


def eval_cuts(records: np.ndarray, cuts: CutTable) -> np.ndarray:
    """Reference predicate-matrix evaluation: (m, n_cuts) bool.

    M[r, c] == True  iff record r satisfies cut c.  numpy implementation; the
    CUDA kernel (kernels/route_records.py) reproduces this bit-exactly.
    """
    m = records.shape[0]
    out = np.zeros((m, cuts.n_cuts), dtype=bool)
    off = cuts.schema.cat_offsets
    for c in range(cuts.n_cuts):
        k = int(cuts.kind[c])
        if k == KIND_RANGE:
            out[:, c] = records[:, cuts.dim[c]] < cuts.cutpoint[c]
        elif k == KIND_IN:
            d = int(cuts.dim[c])
            bitpos = records[:, d].astype(np.int64) + int(off[d])
            out[:, c] = cuts.in_mask[c, bitpos]
        else:
            out[:, c] = cuts.adv[int(cuts.adv_id[c])].evaluate(records)
    return out


def eval_adv(records: np.ndarray, adv: Sequence[AdvPredicate]) -> np.ndarray:
    """(m, n_adv) bool — advanced-predicate truth per record."""
    if not adv:
        return np.zeros((records.shape[0], 0), dtype=bool)
    return np.stack([a.evaluate(records) for a in adv], axis=1)
