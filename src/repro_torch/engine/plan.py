"""Plan cache for the LayoutEngine: packed device operands per tree.

A *plan* is what a backend needs to route/intersect against one frozen
tree on one device: the tree and cut table packed into flat int32/uint8
arrays and uploaded once.  The CUDA kernels take every size as a launch
argument, so nothing is compiled per shape and a batch is never padded:
a plan serves every batch size.  Plans are keyed by

    (tree signature, backend, batch bucket, node bucket,
     leaf bucket, cut bucket, backend options)

with each size rounded up to a power-of-two bucket of at least one warp
(``MIN_BUCKET``).  Route and ingest operands depend only on the frozen
topology (immutable); query operands also depend on the leaf
descriptions and block sizes, which tightening rewrites — those plans key
on a description version that ``IncrementalTightener.apply`` bumps.

The build counters (``build_counts``) move once per plan built, so tests
and ``chip_smoke.py`` can assert that a warm cache builds nothing.
"""

from __future__ import annotations

# qdlint: deterministic-module

import dataclasses
import hashlib
import itertools
import threading
from collections import Counter
from typing import Any, Callable, Hashable

import numpy as np
import torch

from repro_torch.core.predicates import KIND_ADV, KIND_RANGE, CutTable
from repro_torch.core.qdtree import FrozenQdTree
from repro_torch.core.routing import cut_table_arrays
from repro_torch.kernels.ops import pack_words, words

MIN_BUCKET = 32  # one warp: the smallest bucket a size rounds up to

_SIG_COUNTER = itertools.count()  # guarded by: _SIG_LOCK
_SIG_LOCK = threading.Lock()

BUILD_COUNTS: Counter = Counter()  # guarded by: _BUILD_LOCK
_BUILD_LOCK = threading.Lock()


def count_build(name: str) -> None:
    """Called from inside plan builders — runs once per plan built (thread
    shards may build at once, hence the lock)."""
    with _BUILD_LOCK:
        BUILD_COUNTS[name] += 1


def build_counts() -> dict[str, int]:
    with _BUILD_LOCK:
        return dict(BUILD_COUNTS)


def build_delta(before: dict[str, int], after: dict[str, int]) -> dict:
    """Counters that moved between two ``build_counts`` snapshots."""
    return {
        k: after.get(k, 0) - before.get(k, 0)
        for k in sorted(set(before) | set(after))
        if after.get(k, 0) != before.get(k, 0)
    }


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: None means the GPU.

    Raises when there is no CUDA device: only an explicit ``"cpu"`` runs
    on the CPU (the plain versions of the kernels).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def pad_bucket(n: int, minimum: int = 1) -> int:
    """Smallest power of two ≥ max(n, minimum)."""
    target = max(int(n), int(minimum), 1)
    return 1 << (target - 1).bit_length()


def tree_signature(tree: FrozenQdTree) -> int:
    """Stable per-object token (frozen topology is immutable)."""
    sig = getattr(tree, "_engine_sig", None)
    if sig is None:
        with _SIG_LOCK:
            sig = getattr(tree, "_engine_sig", None)
            if sig is None:
                sig = next(_SIG_COUNTER)
                object.__setattr__(tree, "_engine_sig", sig)
    return sig


def desc_version(tree: FrozenQdTree) -> int:
    """Leaf-description version; ``IncrementalTightener.apply`` bumps it."""
    return getattr(tree, "_desc_version", 0)


def cuts_signature(cuts: CutTable) -> int:
    """Content hash of a cut table (plus its schema), cached on the object.

    Unlike :func:`tree_signature` (an identity token), this is a *content*
    signature: two trees built from equal cut tables share it, so workload
    tensorizations (which depend only on schema + cuts) are reused.
    """
    sig = getattr(cuts, "_cuts_sig", None)
    if sig is None:
        h = hashlib.blake2b(digest_size=8)
        for a in (cuts.kind, cuts.dim, cuts.cutpoint, cuts.in_mask,
                  cuts.adv_id):
            h.update(np.ascontiguousarray(a).tobytes())
        h.update(repr(tuple(
            (a.col_a, a.op, a.col_b) for a in cuts.adv
        )).encode())
        h.update(repr(tuple(
            (c.name, c.kind, c.dom) for c in cuts.schema.columns
        )).encode())
        sig = int.from_bytes(h.digest(), "little")
        object.__setattr__(cuts, "_cuts_sig", sig)
    return sig


def workload_signature(wt) -> int:
    """Content hash of a workload's conjunct descriptions (not cached).

    ``WorkloadTensors`` is mutable, so the hash is taken on every call
    (tens of microseconds for a few hundred conjuncts); equal workloads
    share their device operands.
    """
    h = hashlib.blake2b(digest_size=8)
    for a in (wt.q_lo, wt.q_hi, wt.q_cat, wt.q_adv):
        a = np.ascontiguousarray(a)
        h.update(repr((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    return int.from_bytes(h.digest(), "little")


@dataclasses.dataclass(frozen=True)
class PlanKey:
    sig: int
    backend: str
    m_bucket: int
    node_bucket: int
    leaf_bucket: int
    cut_bucket: int
    opts: tuple[Hashable, ...] = ()


@dataclasses.dataclass
class CompiledPlan:
    """A backend-ready routing/intersection plan.

    ``operands`` holds the packed tensors on the plan's device plus the
    integer sizes the kernels take; ``meta`` carries host-side values the
    caller needs.
    """

    key: PlanKey
    operands: dict
    meta: dict


class PlanCache:
    """Keyed plan store with hit/miss accounting (thread-safe)."""

    def __init__(self):
        self._plans: dict[Any, Any] = {}  # guarded by: self._lock
        self._lock = threading.Lock()
        self.hits = 0  # guarded by: self._lock
        self.misses = 0  # guarded by: self._lock

    def get(self, key: Any, builder: Callable[[], Any]) -> Any:
        with self._lock:
            if key in self._plans:
                self.hits += 1
                return self._plans[key]
        # build outside the lock (builders pack and upload operands)
        plan = builder()
        with self._lock:
            self.misses += 1
            self._plans.setdefault(key, plan)
            return self._plans[key]

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def evict(self, predicate: Callable[[Any], bool], keep: int = 0) -> int:
        """Drop every entry whose key satisfies ``predicate``.

        The ``keep`` most recently built of those entries stay.
        """
        with self._lock:
            stale = [k for k in self._plans if predicate(k)]
            stale = stale[: max(len(stale) - keep, 0)]  # insertion order
            for k in stale:
                del self._plans[k]
            return len(stale)

    def stats(self) -> dict:
        # len(self._plans) inlined: __len__ takes this same non-reentrant lock
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "size": len(self._plans),
            }


# ---------------------------------------------------------------------------
# Operand packing (host side), built once per tree by cached plans.
# ---------------------------------------------------------------------------
def path_matrices(tree: FrozenQdTree) -> tuple[np.ndarray, np.ndarray]:
    """PathPos/PathNeg (n_cuts, n_leaves) f32: leaf path constraints.

    ``pos[c, l]`` is 1 iff leaf l's root path requires cut c true,
    ``neg[c, l]`` iff it requires cut c false.  The plain ``locate_leaf``
    finds a record's leaf as the unique column with no violated
    constraint.
    """
    n_cuts = tree.cuts.n_cuts
    pos = np.zeros((n_cuts, tree.n_leaves), np.float32)
    neg = np.zeros((n_cuts, tree.n_leaves), np.float32)
    stack: list[tuple[int, list[tuple[int, bool]]]] = [(0, [])]
    while stack:
        node, cons = stack.pop()
        bid = int(tree.leaf_bid[node])
        if bid >= 0:
            for c, d in cons:
                (pos if d else neg)[c, bid] = 1.0
        else:
            c = int(tree.cut_id[node])
            stack.append((int(tree.left[node]), cons + [(c, True)]))
            stack.append((int(tree.right[node]), cons + [(c, False)]))
    return pos, neg


def pack_nodes(tree: FrozenQdTree) -> np.ndarray:
    """(n_nodes, 4) int32: each node, its cut included, as one 16-byte load.

    ``(meta, left, right, w)``; a leaf is ``(0, block id, -1, 0)``.  The
    cut's kind sits in ``meta``'s top two bits and a column in its low 12:

    * range: ``meta = dim``, ``w`` the cutpoint (``rec[dim] < w``);
    * IN: ``meta = 1 << 30 | cat_off[dim] << 12 | dim``, ``w`` the cut's
      first byte in ``in_mask`` (``c * bits``);
    * advanced: ``meta = 2 << 30 | op << 24 | col_b << 12 | col_a``.

    So a descent reads no cut table but ``in_mask``.  Raises when a column
    index, a bit offset or an in_mask offset does not fit its field.
    """
    cuts = tree.cuts
    ca = cut_table_arrays(cuts)
    bits = int(ca["in_mask"].shape[1])
    c = tree.cut_id.astype(np.int64)
    internal = c >= 0
    cc = np.where(internal, c, cuts.n_cuts)  # leaves read a dummy cut

    def per_cut(a):
        return np.append(np.asarray(a, np.int64), 0)[cc]

    kind, dim = per_cut(ca["kind"]), per_cut(ca["dim"])
    adv = np.concatenate([ca["adv"].astype(np.int64), np.zeros((1, 3),
                                                               np.int64)])
    a = adv[np.where(kind == KIND_ADV, per_cut(ca["adv_id"]), -1)]
    col_a, op, col_b = a[:, 0], a[:, 1], a[:, 2]
    off = ca["cat_off"].astype(np.int64)[dim]
    fields = ((dim, 1 << 12), (col_a, 1 << 12), (col_b, 1 << 12),
              (off, 1 << 18), (op, 1 << 6), (cc * bits, 1 << 31))
    if any(((v[internal] < 0) | (v[internal] >= top)).any()
           for v, top in fields):
        raise ValueError("a cut does not fit the packed node format")
    meta = np.select(
        [kind == KIND_RANGE, kind == KIND_ADV],
        [dim, 2 << 30 | op << 24 | col_b << 12 | col_a],
        1 << 30 | off << 12 | dim,
    )
    w = np.where(kind == KIND_RANGE, per_cut(ca["cutpoint"]),
                 np.where(kind == KIND_ADV, 0, cc * bits))
    out = np.stack([
        np.where(internal, meta, 0),
        np.where(internal, tree.left, tree.leaf_bid),
        np.where(internal, tree.right, -1),
        np.where(internal, w, 0),
    ], axis=1)
    # meta's top bit makes advanced nodes negative as int32: wrap, not clip
    return np.ascontiguousarray(out.astype(np.uint32).view(np.int32))


def pack_route_constants(tree: FrozenQdTree) -> dict:
    """Operands of the route and ingest kernels (numpy, host).

    The cut table (:func:`~repro_torch.core.routing.cut_table_arrays`), the
    node arrays the kernels descend (``nodes`` packed for the ingest
    kernels), the path matrices the plain ``locate_leaf`` uses, the
    categorical dims whose presence bits ingest sets, and the integer
    sizes: ``cw``/``aw`` are the 32-bit words a leaf's categorical and
    advanced-cut bits take.
    """
    schema = tree.schema
    out: dict = dict(cut_table_arrays(tree.cuts))
    pos, neg = path_matrices(tree)
    bits = int(out["in_mask"].shape[1])
    out.update(
        cut_id=tree.cut_id.astype(np.int32),
        left=np.maximum(tree.left, 0).astype(np.int32),
        right=np.maximum(tree.right, 0).astype(np.int32),
        leaf_bid=tree.leaf_bid.astype(np.int32),
        nodes=pack_nodes(tree),
        pathpos=pos,
        pathneg=neg,
        cat_dims=np.nonzero(schema.is_categorical)[0].astype(np.int32),
        depth=int(tree.depth),
        n_leaves=int(tree.n_leaves),
        n_adv=int(tree.cuts.n_adv),
        bits=bits,
        cw=words(bits),
        aw=words(tree.cuts.n_adv),
    )
    return out


def pack_leaf_descs(tree: FrozenQdTree, layout: dict) -> dict:
    """Leaf descriptions and block sizes for the query kernel (numpy, host).

    ``desc`` holds one int32 row per leaf: numeric lo, numeric hi (the
    columns ``layout["num_dims"]``), the categorical bits 32 to a word,
    then the advanced-cut bits seen true and seen false, ``layout["aw"]``
    words each (:func:`repro_torch.kernels.ops.query_layout`).  ``size``
    is the tree's block sizes from its last tightening (zeros for a tree
    never tightened).
    """
    L = tree.n_leaves
    nd, n_adv, aw = layout["num_dims"], layout["n_adv"], layout["aw"]
    adv = tree.leaf_adv[:, :n_adv].astype(bool)
    desc = np.concatenate([
        tree.leaf_lo[:, nd], tree.leaf_hi[:, nd],
        pack_words(tree.leaf_cat.astype(bool), layout["cw"]),
        pack_words(adv[:, :, 0], aw), pack_words(adv[:, :, 1], aw),
    ], axis=1)
    sizes = (
        np.zeros(L, np.int64)
        if tree.block_sizes is None
        else np.asarray(tree.block_sizes, np.int64)
    )
    return {"desc": np.ascontiguousarray(desc, dtype=np.int32),
            "size": sizes}


def to_device(packed: dict, device) -> dict:
    """Upload the arrays of a packed dict; integers pass through."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        if isinstance(v, np.ndarray) else v
        for k, v in packed.items()
    }
