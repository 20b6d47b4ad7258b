"""Semantic result cache: routed block IDs keyed by predicate signatures.

The qd-tree's whole value proposition is cutting blocks-accessed-per-query
(paper Eq. 1) — but a repeated predicate re-paid full routing on every
arrival.  The tracker's canonical predicate signatures are precisely a semantic
cache key: two textually different queries that canonicalize to the same
per-conjunct ``(column, op, bound)`` atom set provably route to the same
``BID IN (...)`` list, so the second one can be answered without touching
the engine at all.

Two deliberate choices keep the cache *sound* (worst-case framing of
arXiv 2405.04984: a cache must never serve block IDs from a retired
layout):

* **Exact canonicalization.**  Cache keys use
  :data:`EXACT_RESOLUTION` buckets — ``bucket_lo/bucket_hi`` degenerate to
  the identity, so a signature captures the query's folded conjunct form
  (numeric box, categorical value sets, cut-visible advanced atoms)
  losslessly.  Equal keys ⇒ equal tensorized form ⇒ bit-identical
  ``query_hits`` — a hit can never alias two queries that route
  differently.  (The tracker's *sketch* signatures stay coarsely bucketed
  on purpose: aggregation wants collisions, a result cache must not.)
* **Epoch-keyed entries.**  Every entry is keyed by the serving
  :class:`~repro_torch.service.epoch.Epoch` ``(generation, desc_version,
  replica_id)``: hot swaps bump the generation
  (:meth:`LayoutService.swap`), in-place tightening bumps the leaf
  description version (``FrozenQdTree.tighten``), and either makes every
  prior entry unreachable — exactly the plan-cache eviction rule, applied
  to results.  Lookups always pass the *live* epoch(s), so a retired
  entry cannot be returned even before :meth:`ResultCache.activate`
  purges it.  Replicated layouts activate one epoch PER replica:
  hot-swapping replica r retires only entries whose epoch carries
  ``replica_id == r`` — the other replicas' results stay warm.
"""

from __future__ import annotations

# qdlint: deterministic-module

import dataclasses
import threading
from collections import OrderedDict
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core import query as qry
from repro_torch.core import predicates as preds
from repro_torch.service.epoch import Epoch
from repro_torch.service.tracker import adv_filter_for, query_signatures

# bucket_lo/bucket_hi return bounds unchanged once n_buckets >= the column
# domain; this resolution exceeds any int32 domain, so canonicalization is
# lossless (signatures are fixed points trivially).
EXACT_RESOLUTION = 1 << 62

def _as_epoch(e) -> Epoch:
    """Every cache key carries a real :class:`Epoch` — the legacy
    ``(generation, desc_version)`` tuple coercion (``Epoch.of``) is gone,
    and a tuple would silently key its own namespace (every lookup a
    miss), so reject it loudly instead."""
    if not isinstance(e, Epoch):
        raise TypeError(
            f"expected an Epoch, got {type(e).__name__}; legacy "
            "(generation, desc_version) tuples are no longer coerced"
        )
    return e


def exact_signatures(
    workload: qry.Workload,
    cuts: Optional[preds.CutTable] = None,
    adv_filter: Optional[frozenset] = None,
) -> list[tuple]:
    """Per-query lossless cache keys (the tracker's canonicalization, exact bounds).

    ``cuts`` restricts advanced atoms to the cut table's — the tensorized
    routing path cannot see non-cut advanced atoms, so two queries that
    differ only in one must share a key (they route identically).
    ``adv_filter`` passes a pre-computed filter instead (the replica
    path: the UNION of every replica's cut-visible atoms, so one key
    determines the tensorized form — and hence the cheapest-replica
    choice — on every replica).
    """
    if adv_filter is None:
        adv_filter = adv_filter_for(cuts)
    return query_signatures(
        workload, EXACT_RESOLUTION, adv_filter=adv_filter
    )


@dataclasses.dataclass
class CacheStats:
    """Monotonic counters over one :class:`ResultCache` lifetime."""

    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0  # LRU capacity pressure
    invalidated: int = 0  # entries purged by an epoch change
    stale_puts: int = 0  # inserts rejected: computed at a retired epoch
    epoch_changes: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        return {
            **dataclasses.asdict(self),
            "lookups": self.lookups,
            "hit_rate": self.hit_rate,
        }


class ResultCache:
    """LRU of routed block-ID lists keyed by ``(epoch, signature)``.

    Thread-safe; values are read-only int32 arrays shared by reference
    (routing results are immutable).  :meth:`activate` pins the cache to
    the live epoch: entries from any other epoch are purged, and inserts
    tagged with a non-live epoch are dropped (``stale_puts``) — a racing
    dispatch that routed on a just-retired generation can never poison
    the cache for the new one.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, np.ndarray] = OrderedDict()  # guarded by: self._lock
        # one activated epoch per replica_id; pre-replica callers only
        # ever populate slot 0
        self._epochs: dict[int, Epoch] = {}  # guarded by: self._lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def epoch(self) -> Optional[Epoch]:
        """The primary replica's activated epoch (compat surface)."""
        with self._lock:
            return self._epochs.get(0)

    def epochs(self) -> tuple[Epoch, ...]:
        """Every activated epoch, replica order."""
        with self._lock:
            return tuple(
                self._epochs[r] for r in sorted(self._epochs)
            )

    def activate(
        self, epoch: Union[Epoch, Sequence[Epoch]]
    ) -> int:
        """Pin the cache to ``epoch`` (one Epoch, or a sequence — one per
        replica); purge that replica's entries from any other epoch.

        Returns the number of entries invalidated.  Idempotent for the
        current epoch (the fast path is one compare under the lock).
        Invalidation is replica-scoped: activating a new epoch for
        replica r leaves the other replicas' entries untouched — a hot
        swap of one replica cannot cold-start the rest of the fleet.
        Rollbacks re-activate an *older* generation: its entries were
        purged when it was swapped out, so it simply restarts cold —
        correctness never depends on the purge, only hygiene does,
        because lookups key on the live epoch(s).
        """
        if isinstance(epoch, Epoch):
            epochs = (epoch,)
        else:
            epochs = tuple(_as_epoch(e) for e in epoch)
        invalidated = 0
        with self._lock:
            for e in epochs:
                if self._epochs.get(e.replica_id) == e:
                    continue
                stale = [
                    k for k in self._entries
                    if k[0].replica_id == e.replica_id and k[0] != e
                ]
                for k in stale:
                    del self._entries[k]
                self._epochs[e.replica_id] = e
                self.stats.invalidated += len(stale)
                self.stats.epoch_changes += 1
                invalidated += len(stale)
        return invalidated

    def get(self, epoch: Epoch, sig: tuple) -> Optional[np.ndarray]:
        """The cached block IDs for ``sig`` at ``epoch``, or None."""
        key = (_as_epoch(epoch), sig)
        with self._lock:
            bids = self._entries.get(key)
            if bids is None:
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return bids

    def get_many(
        self, epoch: Epoch, sigs: list[tuple]
    ) -> list[Optional[np.ndarray]]:
        """Batched :meth:`get`: one lock acquisition for a whole dispatch
        (the cache-hit serving path is lock-bound once signatures are
        memoized, so per-signature locking would dominate it)."""
        return [
            pair[1] if pair is not None else None
            for pair in self.lookup((epoch,), sigs)
        ]

    def lookup(
        self, epochs: Sequence[Epoch], sigs: list[tuple]
    ) -> list[Optional[tuple[Epoch, np.ndarray]]]:
        """Batched multi-replica lookup: for each signature, the first
        hit across ``epochs`` (replica order) as ``(epoch, bids)``, else
        None.  Exactly one hit-or-miss is counted per signature no
        matter how many replicas are live — an entry lives under the
        replica that routed it, so replica order is also cheapest-first
        provenance."""
        keys = tuple(_as_epoch(e) for e in epochs)
        out: list[Optional[tuple[Epoch, np.ndarray]]] = []
        hits = 0
        with self._lock:
            entries = self._entries
            # recency only matters once eviction is in sight; below half
            # capacity the per-hit move_to_end is pure overhead (entries
            # keep insertion order, which is what eviction would use
            # anyway for a cache that never filled)
            touch = 2 * len(entries) > self.capacity
            for sig in sigs:
                found = None
                for e in keys:
                    key = (e, sig)
                    bids = entries.get(key)
                    if bids is not None:
                        if touch:
                            entries.move_to_end(key)
                        found = (e, bids)
                        break
                if found is not None:
                    hits += 1
                out.append(found)
            self.stats.hits += hits
            self.stats.misses += len(sigs) - hits
        return out

    def put(self, epoch: Epoch, sig: tuple, bids: np.ndarray) -> bool:
        """Insert a routed result computed at ``epoch``.

        Returns False (and counts ``stale_puts``) when ``epoch`` is not
        the activated one for its replica — the result was computed
        against a layout that was retired while the dispatch was in
        flight.
        """
        epoch = _as_epoch(epoch)
        value = np.asarray(bids, np.int32)
        value.setflags(write=False)
        with self._lock:
            if self._epochs.get(epoch.replica_id) != epoch:
                self.stats.stale_puts += 1
                return False
            key = (epoch, sig)
            if key not in self._entries:
                self.stats.insertions += 1
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.stats.evictions += 1
            return True

    def snapshot(self) -> dict:
        with self._lock:
            primary = self._epochs.get(0)
            return {
                "size": len(self._entries),
                "capacity": self.capacity,
                "epoch": list(primary) if primary else None,
                "replicas": len(self._epochs),
                **self.stats.as_dict(),
            }


__all__ = [
    "EXACT_RESOLUTION",
    "CacheStats",
    "Epoch",
    "ResultCache",
    "exact_signatures",
]
