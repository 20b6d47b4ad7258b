"""The qd-tree data structure (paper Sec 3).

Two representations:

* ``Node``/``QdTree`` — a Python object tree used during *construction*
  (greedy / WOODBLOCK), where the shape is dynamic.
* ``FrozenQdTree`` — flat int32/bool arrays produced by ``QdTree.freeze()``;
  this is what routing, query processing, the CUDA kernels, and
  serialization consume.  Mirrors the paper's "freeze the tree" step
  (Sec 3.2), including min-max tightening of leaf descriptions.

A tree built by the JAX package carries over unchanged: ``to_arrays``
and ``save`` write the keys that package's ``FrozenQdTree.save`` writes,
and ``FrozenQdTree.from_arrays`` / ``load`` read them back.
"""

from __future__ import annotations

import collections
import dataclasses
import json
from typing import Iterator, Optional

import numpy as np

from repro_torch.core import predicates as preds
from repro_torch.core.predicates import CutTable, Schema

# what FrozenQdTree.save writes, in both packages
_SAVE_KEYS = (
    "cut_id", "left", "right", "leaf_bid", "leaf_lo", "leaf_hi", "leaf_cat",
    "leaf_adv", "depth", "ct_kind", "ct_dim", "ct_cutpoint", "ct_in_mask",
    "ct_adv_id", "ct_adv", "schema",
)


# ---------------------------------------------------------------------------
# Node semantic descriptions (paper Table 1 + Sec 6.1 advanced-cut bits)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class NodeDesc:
    """Semantic description of a node's subspace.

    lo, hi   : (ndims,) int32 — hypercube, hi exclusive.  Categorical dims
               keep [0, dom) here; their information lives in ``cat``.
    cat      : (total_cat_bits,) bool — 1 = value may appear under this node.
    adv      : (n_adv, 2) bool — [i, 0]: may contain records satisfying
               advanced cut i; [i, 1]: may contain records violating it.
               (The paper stores only the first bit; we add the negation bit
               so query routing handles both polarities — DESIGN.md §8.)
    """

    lo: np.ndarray
    hi: np.ndarray
    cat: np.ndarray
    adv: np.ndarray

    def copy(self) -> "NodeDesc":
        return NodeDesc(
            self.lo.copy(), self.hi.copy(), self.cat.copy(), self.adv.copy()
        )


def root_desc(schema: Schema, n_adv: int) -> NodeDesc:
    return NodeDesc(
        lo=np.zeros(schema.ndims, np.int32),
        hi=schema.doms.copy(),
        cat=np.ones(max(schema.total_cat_bits, 1), bool),
        adv=np.ones((n_adv, 2), bool),
    )


def child_descs(
    desc: NodeDesc, cuts: CutTable, cut_id: int
) -> tuple[NodeDesc, NodeDesc]:
    """Restrict a parent description through cut ``cut_id`` (paper Sec 3.2).

    Left child satisfies the cut; right child satisfies its negation.
    """
    left, right = desc.copy(), desc.copy()
    k = int(cuts.kind[cut_id])
    if k == preds.KIND_RANGE:
        d, c = int(cuts.dim[cut_id]), int(cuts.cutpoint[cut_id])
        left.hi[d] = min(left.hi[d], c)
        right.lo[d] = max(right.lo[d], c)
    elif k == preds.KIND_IN:
        mask = cuts.in_mask[cut_id]
        d = int(cuts.dim[cut_id])
        seg = cuts.schema.cat_segment(d)
        left.cat[seg] &= mask[seg]
        right.cat[seg] &= ~mask[seg]
    else:
        a = int(cuts.adv_id[cut_id])
        left.adv[a] = (True, False)
        right.adv[a] = (False, True)
    return left, right


def child_descs_all(
    desc: NodeDesc, cuts: CutTable
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Vectorized ``child_descs`` across *every* candidate cut.

    Returns (left, right), each a dict of stacked arrays:
      lo, hi : (n_cuts, ndims);  cat : (n_cuts, bits);  adv : (n_cuts, n_adv, 2)
    Used by greedy construction to score all cuts in one shot.
    """
    n = cuts.n_cuts
    L = {
        "lo": np.broadcast_to(desc.lo, (n, desc.lo.size)).copy(),
        "hi": np.broadcast_to(desc.hi, (n, desc.hi.size)).copy(),
        "cat": np.broadcast_to(desc.cat, (n, desc.cat.size)).copy(),
        "adv": np.broadcast_to(desc.adv, (n,) + desc.adv.shape).copy(),
    }
    R = {k: v.copy() for k, v in L.items()}

    rng = cuts.kind == preds.KIND_RANGE
    if rng.any():
        idx = np.nonzero(rng)[0]
        dims = cuts.dim[idx]
        cps = cuts.cutpoint[idx]
        L["hi"][idx, dims] = np.minimum(L["hi"][idx, dims], cps)
        R["lo"][idx, dims] = np.maximum(R["lo"][idx, dims], cps)

    inc = cuts.kind == preds.KIND_IN
    if inc.any():
        idx = np.nonzero(inc)[0]
        # in_mask is zero outside the cut's own dim segment, so AND-ing the
        # complement must be limited to the segment.  Build per-cut segment
        # masks once.
        for i in idx:
            seg = cuts.schema.cat_segment(int(cuts.dim[i]))
            L["cat"][i, seg] &= cuts.in_mask[i, seg]
            R["cat"][i, seg] &= ~cuts.in_mask[i, seg]

    advc = cuts.kind == preds.KIND_ADV
    if advc.any():
        idx = np.nonzero(advc)[0]
        aids = cuts.adv_id[idx]
        L["adv"][idx, aids] = np.array([True, False])
        R["adv"][idx, aids] = np.array([False, True])
    return L, R


# ---------------------------------------------------------------------------
# Construction-time object tree
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Node:
    desc: NodeDesc
    rows: Optional[np.ndarray] = None  # indices into the construction sample
    cut_id: int = -1
    left: Optional["Node"] = None
    right: Optional["Node"] = None
    bid: int = -1  # assigned at freeze for leaves

    @property
    def is_leaf(self) -> bool:
        return self.cut_id < 0

    @property
    def size(self) -> int:
        return 0 if self.rows is None else int(self.rows.shape[0])


@dataclasses.dataclass
class QdTree:
    schema: Schema
    cuts: CutTable
    root: Node

    # -- traversal ---------------------------------------------------------
    def nodes(self) -> Iterator[Node]:
        stack = [self.root]
        while stack:
            n = stack.pop()
            yield n
            if not n.is_leaf:
                stack.append(n.right)
                stack.append(n.left)

    def leaves(self) -> list[Node]:
        return [n for n in self.nodes() if n.is_leaf]

    @property
    def n_leaves(self) -> int:
        return len(self.leaves())

    def depth(self) -> int:
        def _d(n: Node) -> int:
            if n.is_leaf:
                return 0
            return 1 + max(_d(n.left), _d(n.right))

        return _d(self.root)

    # -- structural edits (used by greedy / WOODBLOCK) ----------------------
    def split(
        self, node: Node, cut_id: int, sample: Optional[np.ndarray] = None,
        cut_matrix: Optional[np.ndarray] = None,
    ) -> tuple[Node, Node]:
        """Apply cut ``cut_id`` at ``node`` (the paper's ``T ⊕ (p, n)``).

        ``cut_matrix`` is the (m_sample, n_cuts) predicate matrix for the
        construction sample; row sets are split by its ``cut_id`` column.
        """
        if not node.is_leaf:
            raise ValueError("can only split a leaf")
        ld, rd = child_descs(node.desc, self.cuts, cut_id)
        lrows = rrows = None
        if node.rows is not None:
            if cut_matrix is None:
                assert sample is not None
                col = preds.eval_cuts(
                    sample[node.rows],
                    _single_cut(self.cuts, cut_id),
                )[:, 0]
            else:
                col = cut_matrix[node.rows, cut_id]
            lrows = node.rows[col]
            rrows = node.rows[~col]
        node.cut_id = cut_id
        node.left = Node(desc=ld, rows=lrows)
        node.right = Node(desc=rd, rows=rrows)
        return node.left, node.right

    # -- freezing ------------------------------------------------------------
    def freeze(self) -> "FrozenQdTree":
        """Flatten to arrays; assign BIDs to leaves in BFS order."""
        order: list[Node] = []
        bfs = collections.deque([self.root])
        while bfs:
            n = bfs.popleft()
            order.append(n)
            if not n.is_leaf:
                bfs.append(n.left)
                bfs.append(n.right)
        index = {id(n): i for i, n in enumerate(order)}
        nn = len(order)
        cut_id = np.full(nn, -1, np.int32)
        left = np.full(nn, -1, np.int32)
        right = np.full(nn, -1, np.int32)
        leaf_bid = np.full(nn, -1, np.int32)
        leaves = []
        for i, n in enumerate(order):
            if n.is_leaf:
                n.bid = len(leaves)
                leaf_bid[i] = n.bid
                leaves.append(n)
            else:
                cut_id[i] = n.cut_id
                left[i] = index[id(n.left)]
                right[i] = index[id(n.right)]
        ndims = self.schema.ndims
        bits = max(self.schema.total_cat_bits, 1)
        n_adv = self.cuts.n_adv
        nl = len(leaves)
        leaf_lo = np.zeros((nl, ndims), np.int32)
        leaf_hi = np.zeros((nl, ndims), np.int32)
        leaf_cat = np.zeros((nl, bits), bool)
        leaf_adv = np.zeros((nl, n_adv, 2), bool)
        for j, n in enumerate(leaves):
            leaf_lo[j] = n.desc.lo
            leaf_hi[j] = n.desc.hi
            leaf_cat[j] = n.desc.cat
            leaf_adv[j] = n.desc.adv
        # depth of the flattened tree
        depth = self.depth()
        return FrozenQdTree(
            schema=self.schema,
            cuts=self.cuts,
            cut_id=cut_id,
            left=left,
            right=right,
            leaf_bid=leaf_bid,
            leaf_lo=leaf_lo,
            leaf_hi=leaf_hi,
            leaf_cat=leaf_cat,
            leaf_adv=leaf_adv,
            depth=max(depth, 1),
        )


def _single_cut(cuts: CutTable, cut_id: int) -> CutTable:
    sl = slice(cut_id, cut_id + 1)
    return CutTable(
        schema=cuts.schema,
        kind=cuts.kind[sl],
        dim=cuts.dim[sl],
        cutpoint=cuts.cutpoint[sl],
        in_mask=cuts.in_mask[sl],
        adv_id=cuts.adv_id[sl],
        adv=cuts.adv,
    )


# ---------------------------------------------------------------------------
# Frozen (tensorized) tree
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FrozenQdTree:
    """Flat-array qd-tree for routing / query processing / kernels.

    Node arrays are indexed in BFS order (root = 0).  Leaf description arrays
    are indexed by BID.
    """

    schema: Schema
    cuts: CutTable
    cut_id: np.ndarray  # (n_nodes,) int32, -1 for leaves
    left: np.ndarray  # (n_nodes,) int32
    right: np.ndarray  # (n_nodes,) int32
    leaf_bid: np.ndarray  # (n_nodes,) int32, -1 for internal
    leaf_lo: np.ndarray  # (n_leaves, ndims)
    leaf_hi: np.ndarray  # (n_leaves, ndims)
    leaf_cat: np.ndarray  # (n_leaves, bits)
    leaf_adv: np.ndarray  # (n_leaves, n_adv, 2)
    depth: int
    # (n_leaves,) int64 records per block from the last tightening; None
    # until the tree is tightened.  Not serialized: it belongs to the data
    # routed, not to the layout.
    block_sizes: Optional[np.ndarray] = None

    @property
    def n_nodes(self) -> int:
        return int(self.cut_id.shape[0])

    @property
    def n_leaves(self) -> int:
        return int(self.leaf_lo.shape[0])

    # -- routing (numpy reference; the engine's torch backend is the GPU path)
    def route(self, records: np.ndarray) -> np.ndarray:
        """Record → BID (paper Sec 3.1).  Level-synchronous descent."""
        m = records.shape[0]
        M = preds.eval_cuts(records, self.cuts)
        node = np.zeros(m, np.int64)
        for _ in range(self.depth):
            cid = self.cut_id[node]
            internal = cid >= 0
            if not internal.any():
                break
            pred = M[np.arange(m), np.clip(cid, 0, None)]
            nxt = np.where(pred, self.left[node], self.right[node])
            node = np.where(internal, nxt, node)
        return self.leaf_bid[node].astype(np.int32)

    def tighten(self, records: np.ndarray, bids: np.ndarray) -> None:
        """Min-max-tighten leaf descriptions from routed records (Sec 3.2).

        Numeric ranges become [min, max+1); categorical masks keep only
        values actually present; advanced bits reflect observed truth values.
        Empty leaves get a degenerate description that intersects nothing.

        Vectorized (``np.minimum.at``/``bincount``) and expressed as one
        step of :class:`IncrementalTightener`, so streaming ingestion can
        apply the identical update one micro-batch at a time.
        """
        t = IncrementalTightener(self)
        t.update(records, bids)
        t.apply()

    # -- serialization -------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez_compressed(path, **self.to_arrays())

    def to_arrays(self) -> dict[str, np.ndarray]:
        """The tree as the arrays ``save`` writes (the JAX package's keys)."""
        return dict(
            cut_id=self.cut_id,
            left=self.left,
            right=self.right,
            leaf_bid=self.leaf_bid,
            leaf_lo=self.leaf_lo,
            leaf_hi=self.leaf_hi,
            leaf_cat=self.leaf_cat,
            leaf_adv=self.leaf_adv,
            depth=np.array(self.depth),
            # cut table
            ct_kind=self.cuts.kind,
            ct_dim=self.cuts.dim,
            ct_cutpoint=self.cuts.cutpoint,
            ct_in_mask=self.cuts.in_mask,
            ct_adv_id=self.cuts.adv_id,
            ct_adv=np.array(
                [(a.col_a, a.op, a.col_b) for a in self.cuts.adv], np.int32
            ).reshape(-1, 3),
            schema=np.array(json.dumps(
                [(c.name, c.kind, c.dom) for c in self.schema.columns]
            )),
        )

    @staticmethod
    def load(path: str) -> "FrozenQdTree":
        with np.load(path, allow_pickle=False) as z:
            return FrozenQdTree.from_arrays(dict(z))

    @staticmethod
    def from_arrays(arrays: dict[str, np.ndarray]) -> "FrozenQdTree":
        """A tree from exactly the keys ``save`` writes.

        The carry-across function: a JAX-package tree arrives either as the
        dict of its ``save`` keys or through its ``.npz``.  Arrays are
        copied, so the new tree shares no buffer with the caller's.
        """
        if sorted(arrays) != sorted(_SAVE_KEYS):
            raise ValueError(
                f"tree arrays must have exactly the keys {sorted(_SAVE_KEYS)}"
                f"; got {sorted(arrays)}"
            )
        z = {k: np.array(v) for k, v in arrays.items()}
        cols = tuple(
            preds.Column(n, k, int(d)) for n, k, d in json.loads(str(z["schema"]))
        )
        schema = Schema(cols)
        adv = tuple(
            preds.AdvPredicate(int(a), int(o), int(b))
            for a, o, b in z["ct_adv"]
        )
        cuts = CutTable(
            schema=schema,
            kind=z["ct_kind"],
            dim=z["ct_dim"],
            cutpoint=z["ct_cutpoint"],
            in_mask=z["ct_in_mask"],
            adv_id=z["ct_adv_id"],
            adv=adv,
        )
        return FrozenQdTree(
            schema=schema,
            cuts=cuts,
            cut_id=z["cut_id"],
            left=z["left"],
            right=z["right"],
            leaf_bid=z["leaf_bid"],
            leaf_lo=z["leaf_lo"],
            leaf_hi=z["leaf_hi"],
            leaf_cat=z["leaf_cat"],
            leaf_adv=z["leaf_adv"],
            depth=int(z["depth"]),
        )


@dataclasses.dataclass
class TightenPartial:
    """Pre-reduced per-leaf tightening aggregates for one batch.

    The unit of exchange between the fused single-pass ingestion kernels
    (``kernels/fused_ingest.py``, the engine backends) and the tightener:
    the kernel reduces a routed batch to per-leaf partials on device, and
    :meth:`IncrementalTightener.merge` folds them host-side with the same
    elementwise monoid ops (min / max / sum / or) that ``update`` applies
    per record.  ``lo``/``hi`` carry the tightener's int64 identity
    elements on leaves the batch never touched, so merging is exact and
    order-independent — bit-identical to the legacy two-pass route-then-
    ``update`` path for any chunking.
    """

    counts: np.ndarray  # (L,) int64 records routed per leaf
    lo: np.ndarray  # (L, D) int64 batch minima (int64 max where empty)
    hi: np.ndarray  # (L, D) int64 batch maxima, exclusive (int64 min)
    cat: np.ndarray  # (L, bits) bool categorical values present
    adv: np.ndarray  # (L, A, 2) bool advanced-cut truth bits observed


class IncrementalTightener:
    """Streaming min-max tightening of leaf descriptions (Sec 3.2, online).

    Accumulates per-leaf bounds across any number of ``update(records,
    bids)`` micro-batches using vectorized scatter-reductions
    (``np.minimum.at`` / ``np.maximum.at`` / ``bincount``), then ``apply()``
    writes the tightened descriptions into the tree.  Because min, max and
    any are associative, the result is bit-identical to one-shot
    ``FrozenQdTree.tighten`` over the concatenated batches regardless of how
    the stream is chunked.  :meth:`merge` folds a :class:`TightenPartial`
    that a fused kernel already reduced per leaf — same monoid, same bits.
    """

    def __init__(self, tree: "FrozenQdTree"):
        self.tree = tree
        L, d = tree.n_leaves, tree.schema.ndims
        self.lo = np.full((L, d), np.iinfo(np.int64).max, np.int64)
        self.hi = np.full((L, d), np.iinfo(np.int64).min, np.int64)
        self.cat = np.zeros_like(tree.leaf_cat)
        self.adv = np.zeros_like(tree.leaf_adv)
        self.counts = np.zeros(L, np.int64)

    def update(self, records: np.ndarray, bids: np.ndarray) -> None:
        if records.shape[0] == 0:
            return
        tree = self.tree
        bids = np.asarray(bids, np.int64)
        rec64 = records.astype(np.int64, copy=False)
        np.minimum.at(self.lo, bids, rec64)
        np.maximum.at(self.hi, bids, rec64 + 1)  # hi is exclusive
        self.counts += np.bincount(bids, minlength=self.counts.shape[0])
        off = tree.schema.cat_offsets
        for d in np.nonzero(tree.schema.is_categorical)[0]:
            self.cat[bids, off[d] + rec64[:, d]] = True
        if tree.cuts.n_adv:
            t = preds.eval_adv(records, tree.cuts.adv)
            np.logical_or.at(self.adv[:, :, 0], bids, t)
            np.logical_or.at(self.adv[:, :, 1], bids, ~t)

    def merge(self, partial: TightenPartial) -> None:
        """Fold a per-leaf pre-reduced partial (fused kernels, shards)."""
        self.counts += partial.counts
        np.minimum(self.lo, partial.lo, out=self.lo)
        np.maximum(self.hi, partial.hi, out=self.hi)
        self.cat |= partial.cat
        self.adv |= partial.adv

    def as_partial(self) -> TightenPartial:
        """The accumulated state as an exchangeable partial (views)."""
        return TightenPartial(
            counts=self.counts, lo=self.lo, hi=self.hi, cat=self.cat,
            adv=self.adv,
        )

    def apply(self) -> None:
        """Write accumulated bounds into the tree's leaf descriptions."""
        tree = self.tree
        nonempty = self.counts > 0
        ne = nonempty[:, None]
        tree.leaf_lo[:] = np.where(ne, self.lo, 0).astype(
            tree.leaf_lo.dtype, copy=False
        )
        tree.leaf_hi[:] = np.where(ne, self.hi, 0).astype(
            tree.leaf_hi.dtype, copy=False
        )
        tree.leaf_cat[:] = self.cat & ne
        tree.leaf_adv[:] = self.adv & nonempty[:, None, None]
        tree.block_sizes = self.counts.copy()
        # invalidate description-dependent cached plans (engine/plan.py)
        object.__setattr__(
            tree, "_desc_version", getattr(tree, "_desc_version", 0) + 1
        )


def singleton_tree(
    schema: Schema, cuts: CutTable, sample_rows: Optional[np.ndarray] = None
) -> QdTree:
    """T_0: the tree with only a root (paper Alg. 1 initialization)."""
    root = Node(desc=root_desc(schema, cuts.n_adv), rows=sample_rows)
    return QdTree(schema=schema, cuts=cuts, root=root)
