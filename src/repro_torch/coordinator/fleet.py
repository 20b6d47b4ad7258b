"""Fleet coordinator: one process owns the layout epoch for many workers.

Sharded ingest (engine/sharded.py) made block assignment parallel inside
one process; drift detection (service/drift.py) and workload inference
(service/tracker.py) closed the monitor→trigger→rebuild loop — but each
only saw one process's traffic.  The missing piece for the paper's
layout quality story at fleet scale is a single authority that folds
EVERY worker's observations before deciding anything, the continuous
analogue of Lachesis-style background re-optimization (arXiv 2006.16529)
under the dynamic-relayout framing of arXiv 2405.04984.

:class:`FleetCoordinator` is that authority.  Workers — ingest rounds on
thread shards (CUDA streams of one context on the card) or in resident
spawn workers (``ProcessShardSession``), serving threads with local
``WorkloadTracker`` sketches, remote hosts shipping npz'd states —
compute associative partials and :meth:`submit` them; on a cadence the
coordinator drains and folds.  A partial is host data (each shard's
device accumulator is copied back once per run), so the fold itself is
host integer algebra:

* **ShardState partials** merge through the exact int monoid
  (sum/min/max/or) and the merged tightening publishes into the live
  tree under the service lock, compare-and-checked against the
  generation the partials routed — the same stale-generation discipline
  as ``sharded_ingest``, so a rebuild that lands mid-cadence can never
  be polluted by partials of the superseded tree.
* **TrackerState deltas** (``WorkloadTracker.drain_state``) fold into
  the fleet tracker, so workload inference reflects every worker's
  query mix.
* The merged Eq. 1 window partial feeds the fleet
  :class:`~repro_torch.service.drift.AutoRebuilder`, so drift triggers — and
  the rebuilds they fire — see the whole fleet's traffic.

Every fold is associative and commutative on exact ints, so the result
is bit-identical across process boundaries, arrival orders, and fold
cadences (``tests/test_torch_coordinator.py`` pins this, also under
hash-seed randomization; qdlint QD001/QD002/QD005 enforce the lock and
determinism contracts statically).
"""

from __future__ import annotations

# qdlint: deterministic-module

import dataclasses
import threading
from typing import Callable, Optional

from repro_torch.engine.sharded import ShardState
from repro_torch.service.epoch import Epoch
from repro_torch.service.tracker import TrackerState, WorkloadTracker


@dataclasses.dataclass(frozen=True)
class WorkerHandle:
    """One registered fleet worker (identity only — workers hold no
    coordinator state; their partials carry everything)."""

    worker_id: int
    name: str = ""


@dataclasses.dataclass(frozen=True)
class FoldReport:
    """Outcome of one cadence fold."""

    fold: int  # 1-based fold sequence number
    n_partials: int  # shard-state partials drained (incl. stale)
    n_records: int  # records drained into this fold (live partials only)
    published: bool  # merged tightening applied to the live tree
    stale_partials: int  # dropped: routed against a superseded generation
    generation: int  # live generation this fold observed
    tracker_merges: int  # tracker deltas folded into the fleet tracker
    drift: object = None  # DriftDecision | None (fleet rebuilder fed)


class FleetCoordinator:
    """Folds fleet-wide partials on a cadence and drives the layout epoch.

    ``service``    the :class:`~repro_torch.service.service.LayoutService`
                   holding the authoritative epoch (generation ×
                   description version); all publishes and rebuild swaps
                   go through its lock/CAS.
    ``cadence``    submissions per automatic fold (``submit`` returns the
                   FoldReport when its submission completes a cadence;
                   :meth:`fold` drains explicitly at any time).
    ``tracker``    the fleet :class:`WorkloadTracker` (created against
                   the live schema when omitted) — workers ship
                   ``drain_state()`` deltas into it.
    ``rebuilder``  an :class:`~repro_torch.service.drift.AutoRebuilder` fed the
                   merged Eq. 1 window partial each fold; omitted, the
                   coordinator only folds and publishes (drift-less).
    """

    def __init__(
        self,
        service,  # LayoutService (untyped: service does not import us)
        cadence: int = 8,
        tracker: Optional[WorkloadTracker] = None,
        rebuilder=None,  # drift.AutoRebuilder | None
        on_fold: Optional[Callable[[FoldReport], None]] = None,
    ):
        if cadence < 1:
            raise ValueError("cadence must be >= 1")
        self.service = service
        self.cadence = int(cadence)
        self.tracker = (
            tracker if tracker is not None else service.workload_tracker()
        )
        self.rebuilder = rebuilder
        self.on_fold = on_fold
        self._lock = threading.Lock()
        self._next_worker = 0  # guarded by: self._lock
        self._workers: dict[int, WorkerHandle] = {}  # guarded by: self._lock
        self._seq = 0  # guarded by: self._lock -- relabel base for shard ids
        self._pending: list[tuple[int, ShardState]] = []  # guarded by: self._lock
        self._pending_tracker: list[TrackerState] = []  # guarded by: self._lock
        self._since_fold = 0  # guarded by: self._lock
        self._folds = 0  # guarded by: self._lock
        self._stale = 0  # guarded by: self._lock
        # generation-cumulative fold: descriptions published by apply()
        # REPLACE the leaf bounds with the accumulated observation, so a
        # fold must carry every partial of the live generation — else two
        # cadence-1 folds would each erase the other's tightening
        self._acc: Optional[ShardState] = None  # guarded by: self._lock
        self._acc_gen: Optional[int] = None  # guarded by: self._lock

    # -- membership ----------------------------------------------------------
    def register(self, name: str = "") -> WorkerHandle:
        """Join the fleet; returns the handle submissions must carry."""
        with self._lock:
            self._next_worker += 1
            handle = WorkerHandle(
                self._next_worker, name or f"worker-{self._next_worker}"
            )
            self._workers[handle.worker_id] = handle
            return handle

    def leave(self, handle: WorkerHandle) -> None:
        """Leave the fleet.  Partials the worker already submitted stay
        pending — they are valid aggregates of records it really routed —
        only the registration goes; later submits under this handle
        raise."""
        with self._lock:
            self._workers.pop(handle.worker_id, None)

    def workers(self) -> tuple[WorkerHandle, ...]:
        with self._lock:
            return tuple(
                self._workers[k] for k in sorted(self._workers)
            )

    # -- the authoritative epoch --------------------------------------------
    def epoch(self) -> Epoch:
        """The authoritative serving epoch (generation × description
        version of the live primary) every fold publishes against."""
        return self.service.live_epoch()

    # -- submissions ---------------------------------------------------------
    def submit(
        self,
        handle: WorkerHandle,
        state: Optional[ShardState] = None,
        tracker_state: Optional[TrackerState] = None,
        generation: Optional[int] = None,
    ) -> Optional[FoldReport]:
        """Queue one worker's partials; folds when the cadence fills.

        ``state`` — a routing round's :class:`ShardState` (aggregates
        only: the fleet protocol ships partials, never rows, so states
        carrying spill chunks are rejected).  Shard ids are relabeled to
        a coordinator-unique range, so any mix of worker-local shard
        numberings stays mergeable (``ShardState.merge`` rejects
        duplicate ids by contract).

        ``tracker_state`` — a ``WorkloadTracker.drain_state()`` delta.

        ``generation`` — the service generation the partials routed
        against (default: the live generation at submit time).  Partials
        of a superseded generation are dropped at fold time, never
        published.

        Returns the :class:`FoldReport` when this submission completed a
        cadence, else None.
        """
        if state is None and tracker_state is None:
            raise ValueError(
                "submit needs a ShardState and/or a TrackerState"
            )
        if state is not None and state.chunks:
            raise ValueError(
                "coordinator submissions carry aggregates, not rows; "
                "run shards with collect_blocks=False"
            )
        gen = (
            generation
            if generation is not None
            else self.service.generation
        )
        with self._lock:
            if handle.worker_id not in self._workers:
                raise ValueError(
                    f"unregistered worker {handle.name or handle.worker_id}"
                    " (left the fleet?)"
                )
            if state is not None:
                base = self._seq
                self._seq += len(state.shard_ids)
                relabeled = dataclasses.replace(
                    state,
                    shard_ids=tuple(
                        range(base, base + len(state.shard_ids))
                    ),
                )
                self._pending.append((gen, relabeled))
            if tracker_state is not None:
                self._pending_tracker.append(tracker_state)
            self._since_fold += 1
            due = self._since_fold >= self.cadence
        if due:
            return self.fold()
        return None

    # -- the cadence fold ----------------------------------------------------
    def fold(self) -> FoldReport:
        """Drain pending partials: one associative fold, one publish.

        This fold's current-generation partials merge into the
        GENERATION-CUMULATIVE accumulation (``IncrementalTightener.apply``
        replaces descriptions with the accumulated bounds, so every
        publish must carry everything the live generation has seen — two
        cadence-1 folds publishing only their own partials would each
        erase the other's tightening).  The cumulative merge is applied
        to the live tree under the service lock iff that generation is
        STILL live (compare-and-check, exactly the ``sharded_ingest``
        publish discipline); partials routed against a superseded
        generation are dropped and counted — tightening is an
        optimization, so dropping a stale partial only leaves
        descriptions looser, never wrong.  Tracker deltas always fold
        (the query mix outlives any one tree).  The fold-local Eq. 1
        window partial feeds the fleet rebuilder — each observation seen
        exactly once — and a triggered rebuild swaps through the service
        CAS, which resets the accumulation at the next fold.

        Exact int monoid merges all the way down: any drain order or
        cadence partition of the same submissions yields bit-identical
        descriptions, counts, and tracker sketches once all partials
        have folded.
        """
        with self._lock:
            pending, self._pending = self._pending, []
            deltas, self._pending_tracker = self._pending_tracker, []
            self._since_fold = 0
            self._folds += 1
            fold_no = self._folds
        live = self.service.live_version()
        current = [s for g, s in pending if g == live.generation]
        stale = len(pending) - len(current)
        fresh: Optional[ShardState] = None
        for s in current:
            fresh = s if fresh is None else fresh.merge(s)
        with self._lock:
            if self._acc_gen != live.generation:
                # a rebuild swapped the epoch: its tree carries fresh
                # build-time descriptions, so the superseded
                # accumulation has nothing left to say
                self._acc, self._acc_gen = None, live.generation
            if fresh is not None:
                self._acc = (
                    fresh if self._acc is None else self._acc.merge(fresh)
                )
            merged = self._acc
        published = False
        if fresh is not None:
            published = self.service.apply_partial(merged, expected=live)
        for delta in deltas:
            self.tracker.merge_state(delta)
        decision = None
        if (
            self.rebuilder is not None
            and fresh is not None
            and fresh.obs.capacity > 0
        ):
            # the fold-local window partial, not the cumulative merge —
            # the drift window must see each observation exactly once
            decision = self.rebuilder.observe(fresh.obs)
        with self._lock:
            self._stale += stale
        report = FoldReport(
            fold=fold_no,
            n_partials=len(pending),
            n_records=fresh.n_records if fresh is not None else 0,
            published=published,
            stale_partials=stale,
            generation=live.generation,
            tracker_merges=len(deltas),
            drift=decision,
        )
        if self.on_fold is not None:
            self.on_fold(report)
        return report

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "workers": len(self._workers),
                "folds": self._folds,
                "pending": len(self._pending),
                "pending_tracker": len(self._pending_tracker),
                "stale_dropped": self._stale,
                "cadence": self.cadence,
                "accumulated_records": (
                    self._acc.n_records if self._acc is not None else 0
                ),
                "accumulated_generation": self._acc_gen,
            }


__all__ = ["FleetCoordinator", "FoldReport", "WorkerHandle"]
