"""Replica sets: k-replica qd-tree layouts with cheapest-replica routing.

The source paper's critique of fixed blocking schemes is that they "are
unable to exploit additional available storage to drive this metric down
further" — a single qd-tree is one compromise layout for the whole mix.
This module spends a k× storage budget on k *replicas*, each a qd-tree
optimized for one cluster of the live workload, and answers every query
from whichever replica scans the least (the paper's Eq. 1 cost,
evaluated per replica through the same batched ``route_queries`` plan
cache the single-tree path uses).  k=1 degrades to exactly today's
single-copy path.

Clustering rides on the workload tracker: the top-k canonical predicate
signatures (weight-decayed) are embedded as per-dimension
constrained/center features and grouped by deterministic farthest-point
seeding + Lloyd refinement.  Each cluster's build workload blends the
cluster's inferred mix with a **uniform prior over all tracked
signatures** (weight ``lam``, after "Dynamic Data Layout Optimization
with Worst-case Guarantees", arXiv 2405.04984): with ``lam > 0`` no
replica's layout is pathological for out-of-cluster queries, so a
drifting or adversarial mix has bounded regret — the cheapest-replica
router can always fall back to a replica that kept every signature in
view.

The :class:`ReplicaSet` is the deployable artifact: an ordered tuple of
``LayoutVersion``s (index == ``replica_id``), per-replica block sizes
for the Eq. 1 cost model, and the per-replica
:class:`~repro_torch.service.epoch.Epoch` list the serving tier keys its
result cache on (hot-swapping one replica retires only that replica's
entries).
"""

from __future__ import annotations

# qdlint: deterministic-module

import dataclasses
from collections import Counter
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import query as qry
from repro_torch.core.predicates import OP_GE, OP_LT, Schema
from repro_torch.engine import plan as planlib
from repro_torch.service.epoch import Epoch
from repro_torch.service.tracker import (
    SIG_ADV,
    SIG_IN,
    SIG_RANGE,
    adv_filter_for,
    apportion_conjunct_budget,
    query_from_signature,
    query_signatures,
)

# Lossless canonicalization resolution (same trick as the serve cache's
# EXACT_RESOLUTION, duplicated here so the service layer never imports
# the serving tier): bucket_lo/bucket_hi degenerate to the identity.
_EXACT = 1 << 62


# ---------------------------------------------------------------------------
# Workload clustering over canonical signatures
# ---------------------------------------------------------------------------
def signature_features(sig: tuple, schema: Schema) -> np.ndarray:
    """Embed one canonical signature as ``(2 * ndims,)`` features.

    Per dimension: a constrained indicator (any range/IN/advanced atom
    touching it across the signature's conjuncts) and the normalized
    center of the constrained box (0.5 when unconstrained) — enough
    geometry that queries over different columns, or disjoint ranges of
    one column, land far apart, which is what the replica split needs.
    """
    nd = schema.ndims
    doms = schema.doms
    hit = np.zeros(nd, np.float64)
    center_sum = np.zeros(nd, np.float64)
    center_n = np.zeros(nd, np.float64)
    for conj_sig in sig:
        lo = {}
        hi = {}
        for atom in conj_sig:
            tag = atom[0]
            if tag == SIG_RANGE:
                _, d, op, v = atom
                hit[d] = 1.0
                if op == OP_GE:
                    lo[d] = max(lo.get(d, 0), int(v))
                elif op == OP_LT:
                    hi[d] = min(hi.get(d, int(doms[d])), int(v))
            elif tag == SIG_IN:
                d = atom[1]
                hit[d] = 1.0
                vals = atom[2:]
                if vals:
                    center_sum[d] += (
                        float(np.mean(vals)) / max(int(doms[d]), 1)
                    )
                    center_n[d] += 1.0
            elif tag == SIG_ADV:
                d = atom[1]
                hit[d] = 1.0
                center_sum[d] += 0.5
                center_n[d] += 1.0
        for d in sorted(set(lo) | set(hi)):
            a = lo.get(d, 0)
            b = hi.get(d, int(doms[d]))
            center_sum[d] += (a + b) / (2.0 * max(int(doms[d]), 1))
            center_n[d] += 1.0
    centers = np.where(center_n > 0, center_sum / np.maximum(center_n, 1.0),
                       0.5)
    return np.concatenate([hit, centers])


def cluster_signatures(
    items: Sequence[tuple[tuple, float]], schema: Schema, k: int
) -> list[list[int]]:
    """Partition ``[(signature, weight), ...]`` into <= k clusters.

    Deterministic for a fixed input order (callers pass the tracker's
    ``top_signatures`` ordering: weight desc, signature asc): seeds are
    chosen farthest-point-first weighted by signature mass, assignment
    refines through Lloyd rounds with weighted centroids, and every tie
    breaks toward the lowest index.  Empty clusters are dropped, so the
    result may have fewer than k clusters (identical signatures cannot
    be split).  k=1 returns one cluster holding everything.
    """
    n = len(items)
    if n == 0:
        return []
    k = max(1, min(int(k), n))
    if k == 1:
        return [list(range(n))]
    feats = np.stack([signature_features(s, schema) for s, _ in items])
    weights = np.asarray([w for _, w in items], np.float64)
    # farthest-point seeding, mass-weighted: the heaviest signature
    # anchors cluster 0, each next seed is the signature with the most
    # weighted distance to its nearest existing seed
    seeds = [0]
    d2 = ((feats - feats[0]) ** 2).sum(axis=1)
    while len(seeds) < k:
        score = weights * d2
        best = int(np.argmax(score))  # first max — lowest index on ties
        if score[best] <= 0.0:
            break  # every remaining signature sits on an existing seed
        seeds.append(best)
        d2 = np.minimum(d2, ((feats - feats[best]) ** 2).sum(axis=1))
    centers = feats[seeds]
    assign = np.zeros(n, np.int64)
    for _ in range(8):
        dist = ((feats[:, None, :] - centers[None, :, :]) ** 2).sum(axis=2)
        new_assign = dist.argmin(axis=1)  # argmin → lowest cluster on ties
        if np.array_equal(new_assign, assign) and _ > 0:
            break
        assign = new_assign
        for c in range(centers.shape[0]):
            mask = assign == c
            if mask.any():
                wsum = weights[mask].sum()
                centers[c] = (
                    (weights[mask, None] * feats[mask]).sum(axis=0)
                    / (wsum if wsum > 0 else mask.sum())
                )
    clusters = [
        [i for i in range(n) if assign[i] == c]
        for c in range(centers.shape[0])
    ]
    return [c for c in clusters if c]


def blended_mix(
    items: Sequence[tuple[tuple, float]],
    cluster: Sequence[int],
    lam: float,
) -> list[tuple[tuple, float]]:
    """One cluster's build mix: cluster share blended with a uniform
    prior over ALL tracked signatures.

    ``w_c(s) = (1 - lam) * w(s)/W_c * [s in c] + lam / n`` — the
    worst-case blend (arXiv 2405.04984): ``lam = 0`` specializes each
    replica fully, ``lam = 1`` makes every replica build for the uniform
    mix.  Returned heaviest-first (signature asc tie-break), the order
    :func:`materialize_mix` apportions in.
    """
    if not 0.0 <= lam <= 1.0:
        raise ValueError("lam must be in [0, 1]")
    member = set(cluster)
    total_c = sum(items[i][1] for i in cluster)
    total_c = total_c if total_c > 0 else 1.0
    n = len(items)
    out = []
    for i, (sig, w) in enumerate(items):
        blended = lam / n
        if i in member:
            blended += (1.0 - lam) * (w / total_c)
        if blended > 0.0:
            out.append((sig, blended))
    out.sort(key=lambda it: (-it[1], it[0]))
    return out


def materialize_mix(
    items: Sequence[tuple[tuple, float]],
    schema: Schema,
    budget: Optional[int] = 64,
) -> qry.Workload:
    """Weighted signatures → a Workload with integer multiplicities.

    Same conjunct-budget apportionment as
    :meth:`TrackerState.infer_workload` (shared helper), so per-cluster
    workloads get the same stable tensor geometry guarantees.
    """
    items = list(items)
    if not items:
        return qry.Workload(schema, ())
    if budget is None:
        mults = [1] * len(items)
    else:
        items, mults = apportion_conjunct_budget(items, int(budget))
    queries: list[qry.Query] = []
    for (sig, _), m in zip(items, mults):
        queries.extend([query_from_signature(sig, schema)] * m)
    return qry.Workload(schema, tuple(queries))


def workload_signature_weights(
    workload: qry.Workload,
) -> list[tuple[tuple, float]]:
    """Derive ``(signature, weight)`` items from a declared Workload —
    the clustering input when no tracker is serving (weights are exact
    multiplicities of each lossless canonical signature)."""
    counts = Counter(query_signatures(workload, _EXACT))
    items = [(sig, float(c)) for sig, c in counts.items()]
    items.sort(key=lambda it: (-it[1], it[0]))
    return items


def cluster_workloads(
    items: Sequence[tuple[tuple, float]],
    schema: Schema,
    k: int,
    lam: float = 0.25,
    budget: Optional[int] = 64,
) -> tuple[list[qry.Workload], list[tuple[tuple, ...]]]:
    """Cluster tracked signatures and materialize one blended build
    workload per cluster.  Returns ``(workloads, cluster_signatures)``
    (both <= k long; empty clusters dropped)."""
    clusters = cluster_signatures(items, schema, k)
    workloads = []
    sigs = []
    for cluster in clusters:
        workloads.append(
            materialize_mix(blended_mix(items, cluster, lam), schema, budget)
        )
        sigs.append(tuple(items[i][0] for i in cluster))
    return workloads, sigs


# ---------------------------------------------------------------------------
# The deployable artifact
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ReplicaRoute:
    """One query's cheapest-replica answer: the chosen replica's block
    IDs plus the Eq. 1 cost that won (tuples scanned when block sizes
    are known, block count otherwise)."""

    bids: np.ndarray
    replica_id: int
    cost: int


class ReplicaSet:
    """An ordered, immutable set of deployed replicas (index == id).

    ``versions[r]`` is the :class:`LayoutVersion` serving replica ``r``;
    ``block_sizes[r]`` is its per-leaf record count (the Eq. 1 cost
    model — ``None`` for adopted trees with unknown contents, which
    degrades the router to block *counts*).  All replicas share the
    service's one compiled-plan cache: plan keys carry each tree's
    signature, so per-replica routing here is bit-identical to a
    standalone engine over the same tree.
    """

    __slots__ = ("versions", "block_sizes", "provenance")

    def __init__(
        self,
        versions: Sequence,
        block_sizes: Optional[Sequence[Optional[np.ndarray]]] = None,
        provenance: Optional[dict] = None,
    ):
        versions = tuple(versions)
        if not versions:
            raise ValueError("a ReplicaSet needs at least one replica")
        for i, v in enumerate(versions):
            if getattr(v, "replica_id", 0) != i:
                raise ValueError(
                    f"replica at position {i} carries replica_id "
                    f"{v.replica_id}; ids must match positions"
                )
        if block_sizes is None:
            block_sizes = (None,) * len(versions)
        block_sizes = tuple(block_sizes)
        if len(block_sizes) != len(versions):
            raise ValueError("one block_sizes entry per replica required")
        self.versions = versions
        self.block_sizes = block_sizes
        self.provenance = dict(provenance or {})

    @property
    def k(self) -> int:
        return len(self.versions)

    @property
    def primary(self):
        """Replica 0 — the version every single-tree service API serves."""
        return self.versions[0]

    def epochs(self) -> tuple[Epoch, ...]:
        """Per-replica serving epochs, index == replica_id."""
        return tuple(
            Epoch(v.generation, planlib.desc_version(v.tree), i)
            for i, v in enumerate(self.versions)
        )

    def generations(self) -> tuple[int, ...]:
        return tuple(v.generation for v in self.versions)

    def adv_filter(self) -> Optional[frozenset]:
        """The advanced-atom filter for replica-sound cache keys: the
        UNION of every replica's cut-visible advanced predicates.  Equal
        signatures under the union imply equal tensorized forms on every
        replica, hence an identical cheapest-replica choice — for k=1
        this is exactly the single tree's filter (today's cache keys)."""
        parts = [adv_filter_for(v.tree.cuts) for v in self.versions]
        if any(p is None for p in parts):
            return None  # no filtering: strictly finer keys, still sound
        if len(parts) == 1:
            return parts[0]
        return frozenset().union(*parts)

    def replace(self, replica_id: int, version,
                block_sizes: Optional[np.ndarray] = None) -> "ReplicaSet":
        """A new ReplicaSet with one slot swapped (hot swap / rollback
        of a single replica — the others keep serving untouched)."""
        if not 0 <= replica_id < self.k:
            raise ValueError(
                f"replica {replica_id} not in live set (k={self.k})"
            )
        versions = list(self.versions)
        sizes = list(self.block_sizes)
        versions[replica_id] = version
        sizes[replica_id] = block_sizes
        return ReplicaSet(versions, sizes, self.provenance)

    # -- cheapest-replica routing -------------------------------------------
    def route_queries(
        self, workload: qry.Workload, backend: Optional[str] = None,
        transient: bool = False,
    ) -> list[ReplicaRoute]:
        """Route every query on every replica (one batched
        ``route_queries`` dispatch per replica, through the shared plan
        cache) and keep each query's cheapest answer.

        Cost is Eq. 1 over the chosen replica: the total records in the
        blocks the query must scan (block counts when any replica lacks
        sizes, so costs stay comparable).  Ties break on
        ``(cost, n_blocks, block-id bytes)`` — intrinsic to the routed
        content, so the chosen answer is invariant under replica order
        permutation.  ``transient`` keeps the workload out of the plan
        cache (``LayoutEngine.route_queries``).
        """
        per_replica = [
            v.engine.route_queries(
                workload.tensorize(v.tree.cuts), backend=backend,
                transient=transient,
            )
            for v in self.versions
        ]
        use_sizes = all(s is not None for s in self.block_sizes)
        out: list[ReplicaRoute] = []
        for qi in range(len(workload)):
            best = None
            for r in range(self.k):
                bids = per_replica[r][qi]
                if use_sizes:
                    cost = int(self.block_sizes[r][bids].sum())
                else:
                    cost = int(bids.shape[0])
                key = (cost, int(bids.shape[0]), bids.tobytes())
                if best is None or key < best[0]:
                    best = (key, r, bids, cost)
            out.append(
                ReplicaRoute(bids=best[2], replica_id=best[1], cost=best[3])
            )
        return out

    def scanned_fraction(
        self, workload: qry.Workload, n_records: Optional[int] = None
    ) -> float:
        """Eq. 1 over the whole mix with cheapest-replica routing:
        mean over queries of (records scanned / records total).  Needs
        per-replica block sizes; ``n_records`` defaults to the primary's
        total."""
        if not len(workload):
            return 0.0
        if not all(s is not None for s in self.block_sizes):
            raise ValueError(
                "scanned_fraction needs block sizes for every replica"
            )
        if n_records is None:
            n_records = int(self.block_sizes[0].sum())
        routes = self.route_queries(workload)
        total = sum(r.cost for r in routes)
        return total / float(max(n_records, 1) * len(workload))

    def describe(self) -> dict:
        return {
            "k": self.k,
            "generations": list(self.generations()),
            "epochs": [list(e) for e in self.epochs()],
            "n_leaves": [v.tree.n_leaves for v in self.versions],
            **{
                k: v
                for k, v in self.provenance.items()
                if isinstance(v, (int, float, str, bool))
            },
        }


@dataclasses.dataclass
class ReplicaRebuildReport:
    """Outcome of one ``rebuild_replicas`` cycle."""

    k: int  # requested replica count (len(builds) may be smaller)
    lam: float
    builds: tuple  # per-cluster LayoutBuild candidates
    clusters: tuple[tuple[tuple, ...], ...]  # signatures per cluster
    candidate_scanned: float  # cheapest-replica Eq. 1 on the inputs
    live_scanned: float
    swapped: bool
    old_generations: tuple[int, ...]
    new_generations: tuple[int, ...]
    build_s: float
    score_s: float

    @property
    def improvement(self) -> float:
        return self.live_scanned - self.candidate_scanned


def cheapest_scanned_fraction(
    engines: Sequence,
    sizes: Sequence[np.ndarray],
    workload: qry.Workload,
    n_records: int,
) -> float:
    """Eq. 1 scanned fraction under cheapest-replica routing, for
    engines that are not (yet) deployed as a ReplicaSet — the
    rebuild-time scoring path.  ``sizes[r]`` are per-leaf record counts
    measured on the SAME records for every engine, so candidate and
    live sets compare apples-to-apples."""
    if not len(workload):
        return 0.0
    per = [
        eng.route_queries(workload.tensorize(eng.tree.cuts))
        for eng in engines
    ]
    total = 0
    for qi in range(len(workload)):
        total += min(
            int(sizes[r][per[r][qi]].sum()) for r in range(len(engines))
        )
    return total / float(max(n_records, 1) * len(workload))


def block_sizes_for(build, n_leaves: int) -> Optional[np.ndarray]:
    """Per-leaf record counts from a build's routed bids (the Eq. 1
    cost model); None for adopted builds with no routed records."""
    bids = getattr(build, "bids", None)
    if bids is None or len(bids) == 0:
        return None
    return np.bincount(np.asarray(bids), minlength=n_leaves).astype(np.int64)


__all__ = [
    "ReplicaRebuildReport",
    "ReplicaRoute",
    "ReplicaSet",
    "blended_mix",
    "block_sizes_for",
    "cheapest_scanned_fraction",
    "cluster_signatures",
    "cluster_workloads",
    "materialize_mix",
    "signature_features",
    "workload_signature_weights",
]
