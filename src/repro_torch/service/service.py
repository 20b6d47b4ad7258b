"""LayoutService: one lifecycle API over qd-tree layouts.

Construction (the builder registry), serving (routing / batched query
routing through the LayoutEngine), and online re-optimization (versioned
rebuild with hot swap) behind a single facade:

    svc = LayoutService.build(records, workload, strategy="greedy")
    bids = svc.route(records)                 # live tree, any backend
    lists = svc.route_queries(workload)       # batched BID IN (...) lists
    report = svc.rebuild(recent, workload)    # candidate → score → hot swap

Versioning: every deployed tree gets a monotonically-increasing generation.
All generations share ONE compiled-plan cache — plan keys include the tree
signature (engine/plan.py), so the plans of the outgoing tree stay valid and
warm during a swap, and queries in flight against the old engine keep
routing bit-identically until :meth:`release` drops that generation and
evicts its plans.  ``rebuild`` builds a candidate on recent data, scores it
against the live tree with the paper's Eq. 1 skip rate, and swaps only on
strict improvement (or ``swap="always"``); :meth:`rollback` restores any
retained generation.  This is the "tree rebuild-in-place" step toward the
dynamic-layout follow-up (arXiv:2405.04984) and the online re-optimization
loop of Lachesis (arXiv:2006.16529).

Every engine runs the ``torch`` backend on the service's device (the GPU
unless ``device="cpu"``, where the kernels' plain versions run).  A new
generation's plan operands are uploaded by whichever thread built it (the
drift rebuilder's worker, say) on that thread's stream; every deploy
(:meth:`swap`, the compare-and-swap, :meth:`deploy_replicas`) first waits
for the device to finish that work, so no stream can launch against a
generation whose uploads are still in flight.  :meth:`release` does the
same before it evicts a generation's plans.
"""

from __future__ import annotations

# qdlint: deterministic-module (timings use perf_counter and are
# reported, never folded into layouts or plan keys)

import dataclasses
import threading
import time
from concurrent.futures import Executor  # noqa: F401 (re-export for callers)
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import query as qry
from repro_torch.core.qdtree import FrozenQdTree
from repro_torch.engine import LayoutEngine, PlanCache
from repro_torch.engine.engine import WorkloadTensorCache
from repro_torch.engine import plan as planlib
from repro_torch.engine.plan import PlanKey
from repro_torch.service.builders import LayoutBuild, build_layout
from repro_torch.service.epoch import Epoch
from repro_torch.service.options import (
    CPU_BATCH,
    CUDA_BATCH,
    IngestOptions,
    RebuildPolicy,
)
from repro_torch.service.replica import (
    ReplicaRebuildReport,
    ReplicaRoute,
    ReplicaSet,
    block_sizes_for,
    cheapest_scanned_fraction,
    cluster_workloads,
    materialize_mix,
    workload_signature_weights,
)


@dataclasses.dataclass
class LayoutVersion:
    """One deployed tree: generation counter + its engine + build artifact.

    ``replica_id`` is the tree's position in the :class:`ReplicaSet` it
    was deployed into (0 for the primary — and for every version of a
    single-copy service).
    """

    generation: int
    build: LayoutBuild
    engine: LayoutEngine
    replica_id: int = 0

    @property
    def tree(self) -> FrozenQdTree:
        return self.build.tree


@dataclasses.dataclass
class RebuildReport:
    """Outcome of one ``rebuild`` cycle."""

    strategy: str
    build: LayoutBuild  # the candidate (deployed iff ``swapped``)
    candidate_scanned: float  # Eq. 1 scanned fraction on the rebuild inputs
    live_scanned: float
    swapped: bool
    old_generation: int
    new_generation: int  # == old_generation when not swapped
    build_s: float
    score_s: float

    @property
    def improvement(self) -> float:
        return self.live_scanned - self.candidate_scanned


class LayoutService:
    """Versioned layout lifecycle: build → serve → rebuild/swap/rollback."""

    def __init__(
        self,
        layout: LayoutBuild | FrozenQdTree,
        backend: str = "torch",
        device=None,
        plan_cache: Optional[PlanCache] = None,
    ):
        if isinstance(layout, FrozenQdTree):
            layout = _adopt_tree(layout)
        self.backend = backend
        self.device = planlib.resolve_device(device)
        self.plans = plan_cache if plan_cache is not None else PlanCache()
        # one workload-tensor LRU for every generation: entries key on the
        # cut-table *content* signature, so a hot swap to a tree built from
        # an equal cut table keeps standing workloads tensorized
        self._wt_cache = WorkloadTensorCache()
        self._lock = threading.Lock()
        self._gen = 0  # guarded by: self._lock
        self._versions: dict[int, LayoutVersion] = {}  # guarded by: self._lock
        self._swap_listeners: list[Callable[[LayoutVersion], None]] = []  # guarded by: self._lock
        # resident ProcessShardSessions for sharded ingest, keyed by
        # (generation, shards, batch, fused, backend): the tree replica
        # ships to the spawn workers once per generation, not per call
        self._sessions: dict[tuple, object] = {}  # guarded by: self._lock
        # fleet-coordinator registrations: id(coordinator) -> (coordinator,
        # WorkerHandle); the coordinator object is pinned so ids stay unique
        self._coordinators: dict[int, tuple] = {}  # guarded by: self._lock
        self._live = self._new_version(layout)  # swap-guarded by: self._lock
        self._rset = ReplicaSet(  # swap-guarded by: self._lock
            (self._live,),
            (block_sizes_for(self._live.build, self._live.tree.n_leaves),),
        )

    # -- construction --------------------------------------------------------
    @classmethod
    def build(
        cls,
        records: np.ndarray,
        workload: qry.Workload,
        strategy: str = "greedy",
        backend: str = "torch",
        device=None,
        **cfg,
    ) -> "LayoutService":
        """Build an initial layout with any registered strategy and serve it
        (the build's plans land in the service's plan cache)."""
        plans = PlanCache()
        return cls(
            build_layout(records, workload, strategy=strategy,
                         device=device, plan_cache=plans, **cfg),
            backend=backend,
            device=device,
            plan_cache=plans,
        )

    def _new_version(  # qdlint: holds-lock
        self,
        build: LayoutBuild,
        replica_id: int = 0,
        engine: Optional[LayoutEngine] = None,
    ) -> LayoutVersion:
        # all versions share self.plans: plan keys carry the tree signature,
        # so old and new compiled plans coexist during a cutover
        eng = engine if engine is not None else LayoutEngine(
            build.tree,
            backend=self.backend,
            device=self.device,
            plan_cache=self.plans,
            wt_cache=self._wt_cache,
        )
        self._gen += 1
        v = LayoutVersion(
            generation=self._gen, build=build, engine=eng,
            replica_id=replica_id,
        )
        self._versions[v.generation] = v
        return v

    # -- introspection -------------------------------------------------------
    @property
    def generation(self) -> int:
        """Generation of the live tree."""
        return self._live.generation

    @property
    def engine(self) -> LayoutEngine:
        """The live engine (grab once for a consistent view across calls)."""
        return self._live.engine

    @property
    def tree(self) -> FrozenQdTree:
        return self._live.tree

    def live_version(self) -> LayoutVersion:
        """The live :class:`LayoutVersion` — ONE read of the swap pointer.

        Callers that must route and report against a single consistent
        generation (the serving tier's dispatch loop) grab this once and
        use ``v.engine``/``v.tree``/``v.generation`` together; reading the
        ``engine``/``generation`` properties separately can straddle a
        concurrent hot swap.
        """
        return self._live

    def live_epoch(self) -> Epoch:
        """The primary replica's serving :class:`Epoch`.

        Hot swaps and rollbacks change the generation; in-place
        tightening during ingest bumps the live tree's description
        version (changing ``query_hits`` results without a swap).  Either
        movement retires every result computed under the old epoch — this
        is the result-cache invalidation key (`repro_torch.serve.cache`).
        Replicated services have one epoch per replica:
        :meth:`live_epochs`.
        """
        live = self._live
        return Epoch(live.generation, planlib.desc_version(live.tree), 0)

    def live_epochs(self) -> tuple[Epoch, ...]:
        """Per-replica serving epochs of the live ReplicaSet (one
        consistent read; index == replica_id)."""
        return self._rset.epochs()

    def live_replica_set(self) -> ReplicaSet:
        """The live :class:`ReplicaSet` — ONE read of the swap pointer
        (same consistency contract as :meth:`live_version`; its
        ``primary`` is the version every single-tree API serves)."""
        return self._rset

    def replica_generations(self) -> tuple[int, ...]:
        """Live generation per replica, index == replica_id."""
        return self._rset.generations()

    def versions(self) -> tuple[int, ...]:
        """Retained generations, oldest first."""
        with self._lock:
            return tuple(sorted(self._versions))

    def version(self, generation: int) -> LayoutVersion:
        with self._lock:
            return self._versions[generation]

    def stats(self) -> dict:
        return {
            "generation": self.generation,
            "versions": self.versions(),
            "backend": self.backend,
            "device": str(self.device),
            "replicas": self._rset.k,
            "replica_generations": self.replica_generations(),
            "plan_cache": self.plans.stats(),
        }

    # -- serving facade (always the live tree) ------------------------------
    def route(self, records: np.ndarray, **kw) -> np.ndarray:
        return self._live.engine.route(records, **kw)

    def query_hits(self, workload, **kw) -> np.ndarray:
        return self._live.engine.query_hits(workload, **kw)

    def route_query(self, query: qry.Query, **kw) -> np.ndarray:
        return self._live.engine.route_query(query, **kw)

    def route_queries(self, workload, **kw) -> list[np.ndarray]:
        return self._live.engine.route_queries(workload, **kw)

    def serve(
        self, workload, tracker=None, tick: bool = True, **kw
    ) -> list[np.ndarray]:
        """Serve one batch of live queries: batched ``route_queries``
        against the live tree, optionally observed into a
        :class:`~repro_torch.service.tracker.WorkloadTracker`.

        This is the workload auto-detection seam: with ``tracker`` set,
        each served query's canonical predicate signature is recorded, and
        ``tick=True`` (default) closes the serving round afterwards — one
        exponential-decay generation per ``serve`` call, so the inferred
        mix follows what users are asking *now*.  Sharded serving gives
        each worker its own tracker and folds the states
        (``tracker.merge_state`` / ``repro_torch.service.tracker.merge_states``)
        — bit-identical to single-stream tracking, same algebra as
        ``ShardState``.  A served batch is an ephemeral workload: its
        operands are transient (``LayoutEngine.route_queries``), so serving
        builds no plan and evicts no standing workload's operands.
        """
        kw.setdefault("transient", True)
        lists = self._live.engine.route_queries(
            workload, track=tracker, **kw
        )
        if tracker is not None and tick:
            tracker.tick()
        return lists

    def workload_tracker(self, config=None):
        """A :class:`~repro_torch.service.tracker.WorkloadTracker` bound to the
        live schema — pass it to :meth:`serve`/``route_queries(track=...)``
        and to ``auto_rebuilder(workload="auto", tracker=...)`` to close
        the queries-in → layouts-out loop without a declared workload."""
        from repro_torch.service.tracker import WorkloadTracker

        return WorkloadTracker(self.tree.schema, config=config)

    def skip_stats(self, records, workload, **kw):
        return self._live.engine.skip_stats(records, workload, **kw)

    def ingest(
        self,
        records,  # np.ndarray | Iterable[np.ndarray]
        options: Optional[IngestOptions] = None,
        **kw,
    ):
        """Ingestion into the live primary — the ONE ingest entry point.

        ``records`` is either an iterable of micro-batches (streamed
        through ``LayoutEngine.ingest``) or a single record array (numpy,
        or an int32 tensor on the service's device), which is
        micro-batched at :meth:`ingest_batch` rows.  Everything else is
        :class:`IngestOptions`:

        * ``shards=k`` (k >= 2; needs a record array) splits the stream
          across k ShardIngestors — resident spawn-pool workers by
          default (``executor``) — folds their ShardStates
          associatively, and publishes the merged tightening under the
          service lock.  Bit-identical to the streaming path over the
          same records.  The per-generation worker sessions are cached
          on the service, so the tree replica ships to the pool once per
          generation, not once per call.
        * ``coordinator`` (a
          :class:`~repro_torch.coordinator.FleetCoordinator`) turns the run
          into a fleet worker: route and aggregate here, publish THERE —
          the merged ShardState is submitted for the coordinator's cadence
          fold instead of being applied locally.
        * ``monitor`` (an :class:`~repro_torch.service.drift.AutoRebuilder`)
          tees batches into the monitor's reservoir and scores them
          against its standing workload (Eq. 1 per-batch accounting
          through the compiled plan); the monitor may fire a background
          rebuild mid-stream.

        Remaining ``**kw`` passes through to the engine layer
        (``tighten=``, ``buffers=``, ``backend=`` ...).

        The run routes/tightens the engine captured at call time — a
        concurrent hot swap takes effect for the *next* call.  On the
        streaming path, post-swap observations (which still measure the
        superseded tree) are dropped rather than fed to the freshly
        rebaselined monitor; on the sharded path, liveness is re-checked
        under the lock at publish time and a stale run returns its
        (still-valid) aggregates with ``published=False,
        stale_generation=True``.

        Replicated services ingest into the primary replica; secondary
        replicas are read-optimized copies refreshed by the next
        ``rebuild_replicas`` deploy (see ``repro_torch.service.replica``).
        """
        options = options if options is not None else IngestOptions()
        options = dataclasses.replace(options,
                                      batch=self.ingest_batch(options))
        shards = options.shards or 1
        sharded = shards >= 2 or options.coordinator is not None
        if isinstance(records, (np.ndarray, torch.Tensor)):
            if sharded:
                return self._ingest_sharded(records, shards, options, kw)
            from repro_torch.engine.sharded import micro_batches

            batches = micro_batches(records, options.batch)
        elif sharded:
            raise TypeError(
                "IngestOptions(shards=/coordinator=) needs a record "
                "array, not a batch iterable"
            )
        else:
            batches = records
        live = self._live
        monitor = options.monitor
        if options.observe is not None:
            kw["observe"] = options.observe
        kw.setdefault("fused", options.fused)
        if monitor is not None:
            # a workload="auto" monitor resolves to the tracker-inferred
            # live mix here, at the start of each run; an empty inference
            # (nothing served yet) skips accounting rather than probing a
            # zero-query workload
            if "observe" not in kw:
                observed = monitor.current_workload()
                if observed is not None and len(observed):
                    kw["observe"] = observed

            def _observe_if_live(stat):
                if self._live is live:
                    monitor.observe(stat)

            kw.setdefault("on_observation", _observe_if_live)
            batches = monitor.tee(batches)
        return live.engine.ingest(batches, **kw)

    def ingest_batch(self, options: IngestOptions) -> int:
        """Rows a micro-batch when :meth:`ingest` splits a record array:
        ``options.batch``, else CUDA_BATCH on the card and CPU_BATCH on the
        CPU."""
        if options.batch is not None:
            return options.batch
        return CUDA_BATCH if self.device.type == "cuda" else CPU_BATCH

    def _ingest_sharded(self, records, n_shards, options, kw):
        """The sharded arm of :meth:`ingest` (record array, shards >= 2
        and/or a fleet coordinator)."""
        from repro_torch.engine.sharded import sharded_ingest

        live = self._live  # consistent engine/tree view for the whole run
        monitor = options.monitor
        coordinator = options.coordinator
        if options.observe is not None:
            kw["observe"] = options.observe
        kw.setdefault("fused", options.fused)
        if monitor is not None and "observe" not in kw:
            observed = monitor.current_workload()
            if observed is not None and len(observed):
                kw["observe"] = observed
        session = None
        # the port's default for k >= 2 shards: spawn workers on the CPU,
        # CUDA streams of one context on a GPU (sharded.resolve_executor)
        if options.executor == "process" or (
            options.executor is None
            and n_shards >= 2
            and live.engine.device.type != "cuda"
        ):
            session = self._shard_session(live, n_shards, options, kw)
        if coordinator is not None:
            # route-and-aggregate only: the coordinator owns every
            # publish, so local tightening is off and the merged partial
            # ships to its cadence fold instead
            kw.setdefault("tighten", False)
            kw["keep_state"] = True
        report = sharded_ingest(
            live.engine, records, n_shards, batch=options.batch,
            executor=options.executor, lock=self._lock,
            publish_check=lambda: self._live is live,
            session=session, **kw,
        )
        if coordinator is not None and report.state is not None:
            state = report.state
            if state.chunks:
                # the fleet protocol ships aggregates, never rows: any
                # spill chunks were already drained into the caller's
                # local buffers by sharded_ingest
                state = dataclasses.replace(state, chunks={})
            coordinator.submit(
                self._coordinator_handle(coordinator),
                state=state,
                generation=live.generation,
            )
        if monitor is not None:
            monitor.add_records(records)
            if report.observation is not None:
                monitor.observe(report.observation)
        return report

    def _shard_session(self, live, n_shards, options, kw):
        """The cached resident worker session for this (generation, shape).

        Sessions of superseded generations are closed and dropped on the
        way — their replicas route the outgoing tree and must not serve
        another round.
        """
        from repro_torch.engine.sharded import ProcessShardSession

        backend = kw.get("backend")
        key = (
            live.generation, n_shards, options.batch, options.fused,
            backend,
        )
        with self._lock:
            dropped = [
                self._sessions.pop(k)
                for k in list(self._sessions)
                if k[0] != live.generation
            ]
            session = self._sessions.get(key)
            if session is None:
                session = ProcessShardSession(
                    live.engine, n_shards, batch=options.batch,
                    backend=backend, fused=options.fused,
                )
                self._sessions[key] = session
        for s in dropped:
            s.close()
        return session

    def close_ingest_sessions(self) -> None:
        """Release every cached sharded-ingest worker session (the
        resident spawn pool itself is module-owned:
        ``repro_torch.engine.sharded.shutdown_process_pool``)."""
        with self._lock:
            sessions, self._sessions = list(self._sessions.values()), {}
        for s in sessions:
            s.close()

    def _coordinator_handle(self, coordinator):
        """This service's :class:`~repro_torch.coordinator.WorkerHandle`
        with ``coordinator`` (registered once per coordinator object)."""
        with self._lock:
            entry = self._coordinators.get(id(coordinator))
            if entry is None:
                entry = (
                    coordinator,
                    coordinator.register(f"svc-{id(self):x}"),
                )
                self._coordinators[id(coordinator)] = entry
        return entry[1]

    def apply_partial(self, state, expected=None) -> bool:
        """Publish a merged :class:`~repro_torch.engine.sharded.ShardState`
        tightening into the live tree; returns True iff it landed.

        The fleet-coordinator publish seam (``repro_torch.coordinator``):
        fold worker partials anywhere — other processes, other hosts — and
        apply the merged aggregate here under the service lock, with the
        same ``IncrementalTightener.apply`` + description-version bump a
        local ``ingest`` run performs.  ``expected`` (a
        :class:`LayoutVersion`, usually from :meth:`live_version` at
        routing time) makes the publish a compare-and-check: if a rebuild
        swapped the live tree while the partials were in flight, nothing
        is mutated and False is returned — the exact stale-generation
        discipline of a sharded :meth:`ingest`.
        """
        from repro_torch.engine.sharded import MergeCoordinator

        with self._lock:
            live = self._live
            if expected is not None and live is not expected:
                return False
            if state.n_leaves != live.tree.n_leaves:
                raise ValueError(
                    f"partial has {state.n_leaves} leaves; live tree has "
                    f"{live.tree.n_leaves} (built against another layout?)"
                )
            coordinator = MergeCoordinator(live.tree)
            coordinator.add(state)
            coordinator.publish()
            return True

    def auto_rebuilder(self, policy: RebuildPolicy, **kw):
        """An :class:`~repro_torch.service.drift.AutoRebuilder` bound to this
        service: pass it as the ingest monitor and the service becomes
        self-optimizing — skip-rate drift past the configured policy
        triggers a background ``rebuild`` whose deployment rides the same
        compare-and-swap as manual rebuilds.

        Takes one :class:`RebuildPolicy`::

            svc.auto_rebuilder(RebuildPolicy(workload="auto", tracker=t,
                                             drift=DriftConfig(...)))

        A policy with ``replicas > 1`` makes triggered rebuilds deploy a
        k-replica set (``rebuild_replicas``) instead of a single tree.
        ``RebuildPolicy.workload`` is either a declared standing
        :class:`~repro_torch.core.query.Workload` or the string ``"auto"``:
        then drift accounting and rebuilds score against the live mix a
        :class:`~repro_torch.service.tracker.WorkloadTracker` inferred from the
        serving path (``RebuildPolicy(tracker=...)`` shares the one
        :meth:`serve` records into; omitted, a fresh
        :meth:`workload_tracker` is created and exposed as
        ``rebuilder.tracker``).  Remaining ``**kw`` (``reservoir=``,
        ``on_event=``) forwards to ``AutoRebuilder.from_policy``.
        """
        from repro_torch.service.drift import AutoRebuilder

        return AutoRebuilder.from_policy(self, policy, **kw)

    # -- lifecycle: swap / rollback / release --------------------------------
    def subscribe(self, listener: Callable[[LayoutVersion], None]) -> None:
        """Register a callback fired after every live-version change.

        The callback receives the NEW live :class:`LayoutVersion` and runs
        on the swapping thread, outside the service lock (it may call back
        into the service).  The serving tier uses this to invalidate its
        result cache and warm the incoming generation's plans promptly,
        rather than discovering the swap at the next dispatch.
        """
        with self._lock:
            self._swap_listeners.append(listener)

    def unsubscribe(self, listener: Callable[[LayoutVersion], None]) -> None:
        with self._lock:
            try:
                self._swap_listeners.remove(listener)
            except ValueError:
                pass

    def _notify_swap(self, v: LayoutVersion) -> None:
        with self._lock:
            listeners = tuple(self._swap_listeners)
        for fn in listeners:
            fn(v)

    def _settle_device(self) -> None:
        """Wait until the device has finished all queued work: the uploads
        of a generation about to go live (or the last reads of one about to
        be evicted), whichever thread's stream queued them."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def swap(self, build: LayoutBuild) -> int:
        """Deploy ``build`` as the new PRIMARY generation (atomic);
        returns it.  Secondary replicas keep serving untouched — their
        cache entries stay valid (per-replica invalidation)."""
        self._settle_device()
        with self._lock:
            v = self._new_version(build)
            self._live = v  # single reference assignment — atomic swap
            self._rset = self._rset.replace(
                0, v, block_sizes_for(build, build.tree.n_leaves)
            )
        self._notify_swap(v)
        return v.generation

    def _swap_if_live_is(
        self, expected: LayoutVersion, build: LayoutBuild
    ) -> Optional[int]:
        """Compare-and-swap: deploy ``build`` only if ``expected`` is still
        live.  Returns the new generation, or None if the baseline went
        stale (another swap won the race)."""
        self._settle_device()
        with self._lock:
            if self._live is not expected:
                return None
            v = self._new_version(build)
            self._live = v
            self._rset = self._rset.replace(
                0, v, block_sizes_for(build, build.tree.n_leaves)
            )
        self._notify_swap(v)
        return v.generation

    def rollback(self, generation: Optional[int] = None) -> int:
        """Make a retained generation live again FOR ITS REPLICA.

        Rollback is per-replica: the restored version replaces only the
        slot it was deployed into (its ``replica_id``); the other
        replicas keep serving their current trees.  Default: the
        primary's previous retained generation.  A generation whose
        replica slot no longer exists (the live set shrank since it was
        deployed) cannot be restored.
        """
        with self._lock:
            if generation is None:
                older = [
                    g for g, u in self._versions.items()
                    if u.replica_id == 0 and g < self._live.generation
                ]
                if not older:
                    raise ValueError("no older generation to roll back to")
                generation = max(older)
            v = self._versions.get(generation)
            if v is None:
                raise ValueError(
                    f"unknown or released generation {generation}; "
                    f"retained: {tuple(sorted(self._versions))}"
                    f"{self._replica_holders()}"
                )
            rid = v.replica_id
            if rid >= self._rset.k:
                raise ValueError(
                    f"generation {generation} was deployed as replica "
                    f"{rid}, but the live set has k={self._rset.k}; "
                    f"deploy a replica set of that size first"
                )
            self._rset = self._rset.replace(
                rid, v, block_sizes_for(v.build, v.tree.n_leaves)
            )
            if rid == 0:
                self._live = v
        self._notify_swap(v)
        return generation

    def _replica_holders(self) -> str:  # qdlint: holds-lock
        """``" (held by replica r0: 1, 2)"``-style suffix naming which
        replica slot each retained generation belongs to."""
        by_rid: dict[int, list[int]] = {}
        for g in sorted(self._versions):
            by_rid.setdefault(self._versions[g].replica_id, []).append(g)
        parts = ", ".join(
            f"r{rid}: {', '.join(map(str, gens))}"
            for rid, gens in sorted(by_rid.items())
        )
        return f" (held by replica {parts})" if parts else ""

    def release(self, generation: int) -> int:
        """Drop a retained generation and evict its compiled plans.

        Returns the number of plan-cache entries evicted.  A generation
        live in ANY replica slot cannot be released.

        Plan signatures are refcounted across retained versions: when the
        released generation's tree also backs another retained generation
        (re-deploying the same build — e.g. force-swapping an ``if_better``
        candidate, then rolling forward again — yields distinct
        generations over one tree object), its compiled plans stay cached
        until the LAST holder is released.  Evicting on first release
        would silently cold-start a generation that is still serving.
        A run still holding the generation's engine keeps its operands
        alive; the device is settled first, so no queued kernel reads
        memory the allocator hands out again.
        """
        self._settle_device()
        with self._lock:
            live_gens = self._rset.generations()
            if generation in live_gens:
                raise ValueError(
                    f"cannot release the live generation (serving as "
                    f"replica {live_gens.index(generation)})"
                )
            v = self._versions.get(generation)
            if v is None:
                raise ValueError(
                    f"unknown or released generation {generation}; "
                    f"retained: {tuple(sorted(self._versions))}"
                    f"{self._replica_holders()}"
                )
            del self._versions[generation]
            sig = planlib.tree_signature(v.tree)
            if any(
                planlib.tree_signature(u.tree) == sig
                for u in self._versions.values()
            ):
                return 0  # another retained generation still holds these
            return self.plans.evict(
                lambda k: isinstance(k, PlanKey) and k.sig == sig
            )

    # -- rebuild-in-place ----------------------------------------------------
    def rebuild(
        self,
        records: np.ndarray,
        workload: qry.Workload,
        strategy: Optional[str] = None,
        swap: str = "if_better",  # "if_better" | "always" | "never"
        on_candidate: Optional[Callable[[LayoutBuild], None]] = None,
        **cfg,
    ) -> RebuildReport:
        """Build a candidate on ``records``, score vs live, hot-swap.

        The candidate is constructed and scored entirely off to the side:
        serving keeps hitting the current tree (and its cached plans)
        until the single atomic swap.  Scoring is the paper's Eq. 1
        scanned fraction over (records, workload); the live tree is scored
        with ``tighten=False`` so production descriptions aren't mutated.
        ``on_candidate`` (if given) runs after the candidate is built and
        scored but before any swap — a seam for tests and monitoring.
        """
        if swap not in ("if_better", "always", "never"):
            raise ValueError(f"invalid swap policy {swap!r}")
        live = self._live  # consistent view for the whole cycle
        if strategy is None:
            from repro_torch.service.builders import available_strategies

            # adopted trees (bare FrozenQdTree) carry no registered
            # strategy — rebuild them with the greedy default
            strategy = live.build.strategy
            if strategy not in available_strategies():
                strategy = "greedy"
        candidate = build_layout(
            records, workload, strategy=strategy, device=self.device,
            plan_cache=self.plans, **cfg
        )
        t0 = time.perf_counter()
        candidate_scanned = candidate.scanned_fraction
        live_scanned = live.engine.skip_stats(
            records, workload, tighten=False
        ).scanned_fraction
        score_s = time.perf_counter() - t0
        if on_candidate is not None:
            on_candidate(candidate)
        if swap == "always":
            new_gen = self.swap(candidate)
            do_swap = True
        elif swap == "if_better" and candidate_scanned < live_scanned:
            # compare-and-swap: the improvement was measured against
            # ``live`` — if a concurrent rebuild already replaced it, the
            # comparison is stale, so don't deploy on top of it
            got = self._swap_if_live_is(live, candidate)
            do_swap = got is not None
            new_gen = got if do_swap else live.generation
        else:
            do_swap = False
            new_gen = live.generation
        return RebuildReport(
            strategy=strategy,
            build=candidate,
            candidate_scanned=candidate_scanned,
            live_scanned=live_scanned,
            swapped=do_swap,
            old_generation=live.generation,
            new_generation=new_gen,
            build_s=candidate.build_s,
            score_s=score_s,
        )

    # -- replica sets: k layouts, cheapest-replica routing -------------------
    def route_queries_cheapest(
        self, workload: qry.Workload, backend: Optional[str] = None
    ) -> list[ReplicaRoute]:
        """Route every query to its cheapest live replica (Eq. 1 cost
        per replica through the shared plan cache).  With k=1 this is
        the plain batched ``route_queries`` answer plus its cost."""
        return self._rset.route_queries(workload, backend=backend)

    def deploy_replicas(
        self,
        builds: Sequence[LayoutBuild],
        provenance: Optional[dict] = None,
    ) -> ReplicaSet:
        """Atomically deploy one build per replica slot (index ==
        replica_id; the first becomes the primary every single-tree API
        serves).  Each build gets its own generation; swap listeners
        fire once per replica so the serving tier invalidates each
        replica's cache entries."""
        rset = self._deploy_replicas(builds, None, provenance, expected=None)
        assert rset is not None
        return rset

    def _deploy_replicas(
        self,
        builds: Sequence[LayoutBuild],
        engines: Optional[Sequence[LayoutEngine]],
        provenance: Optional[dict],
        expected: Optional[ReplicaSet],
    ) -> Optional[ReplicaSet]:
        """Deploy under the lock; with ``expected`` set this is a CAS on
        the replica-set pointer (None return = baseline went stale)."""
        builds = tuple(builds)
        if not builds:
            raise ValueError("deploy_replicas needs at least one build")
        self._settle_device()
        with self._lock:
            if expected is not None and self._rset is not expected:
                return None
            versions = tuple(
                self._new_version(
                    b,
                    replica_id=i,
                    engine=engines[i] if engines is not None else None,
                )
                for i, b in enumerate(builds)
            )
            sizes = tuple(
                block_sizes_for(b, b.tree.n_leaves) for b in builds
            )
            rset = ReplicaSet(versions, sizes, provenance)
            self._rset = rset
            self._live = versions[0]
        for v in versions:
            self._notify_swap(v)
        return rset

    def rebuild_replicas(
        self,
        records: np.ndarray,
        workload: Optional[qry.Workload] = None,
        k: int = 2,
        lam: float = 0.25,
        strategy: Optional[str] = None,
        swap: str = "if_better",  # "if_better" | "always" | "never"
        tracker=None,
        top_k: int = 16,
        budget: Optional[int] = 64,
        **cfg,
    ) -> ReplicaRebuildReport:
        """Cluster the live mix into <= k workload clusters, build one
        qd-tree replica per cluster, score the set against the live one
        with cheapest-replica Eq. 1 routing, and hot-deploy on
        improvement.

        The clustering input is the ``tracker``'s top-k canonical
        signatures when given (the serving-path inferred mix), else the
        exact signature multiplicities of ``workload``.  Each cluster's
        build workload blends its share of the mix with a uniform prior
        over ALL tracked signatures (weight ``lam`` — the worst-case
        guarantee blend of arXiv 2405.04984).  ``k=1`` degrades to one
        replica built for the whole mix, i.e. today's single-copy path.

        Scoring routes ``workload`` (or the materialized mix) through
        both candidate and live sets with per-leaf record counts
        measured on the SAME ``records`` — monotone in k by
        construction, since each query takes its cheapest replica.
        Deployment is a compare-and-swap on the replica-set pointer:
        a concurrent deploy invalidates this cycle's comparison, so the
        candidate is dropped (``swapped=False``).
        """
        if swap not in ("if_better", "always", "never"):
            raise ValueError(f"invalid swap policy {swap!r}")
        live_rset = self._rset  # consistent view for the whole cycle
        schema = live_rset.primary.tree.schema
        items = tracker.top_signatures(top_k) if tracker is not None else []
        if not items:
            if workload is None or not len(workload):
                raise ValueError(
                    "rebuild_replicas needs a tracker with recorded "
                    "traffic or a non-empty workload to cluster"
                )
            items = workload_signature_weights(workload)
        eval_wl = (
            workload
            if workload is not None and len(workload)
            else materialize_mix(items, schema, budget)
        )
        if strategy is None:
            from repro_torch.service.builders import available_strategies

            strategy = live_rset.primary.build.strategy
            if strategy not in available_strategies():
                strategy = "greedy"
        cluster_wls, cluster_sigs = cluster_workloads(
            items, schema, k, lam, budget
        )
        t0 = time.perf_counter()
        builds = tuple(
            build_layout(records, wl_c, strategy=strategy,
                         device=self.device, plan_cache=self.plans, **cfg)
            for wl_c in cluster_wls
        )
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        # candidate engines share the service plan cache so the deployed
        # set starts warm; per-leaf sizes for BOTH sets come from the
        # same records, making the Eq. 1 comparison apples-to-apples
        cand_engines = tuple(
            LayoutEngine(
                b.tree,
                backend=self.backend,
                device=self.device,
                plan_cache=self.plans,
                wt_cache=self._wt_cache,
            )
            for b in builds
        )
        cand_sizes = [block_sizes_for(b, b.tree.n_leaves) for b in builds]
        candidate_scanned = cheapest_scanned_fraction(
            cand_engines, cand_sizes, eval_wl, len(records)
        )
        live_sizes = [
            np.bincount(
                v.engine.route(records), minlength=v.tree.n_leaves
            ).astype(np.int64)
            for v in live_rset.versions
        ]
        live_scanned = cheapest_scanned_fraction(
            [v.engine for v in live_rset.versions],
            live_sizes,
            eval_wl,
            len(records),
        )
        score_s = time.perf_counter() - t0
        provenance = {
            "k": int(k),
            "lam": float(lam),
            "strategy": strategy,
            "clusters": len(builds),
        }
        old_gens = live_rset.generations()
        deployed = None
        if swap == "always":
            deployed = self._deploy_replicas(
                builds, cand_engines, provenance, expected=None
            )
        elif swap == "if_better" and candidate_scanned < live_scanned:
            deployed = self._deploy_replicas(
                builds, cand_engines, provenance, expected=live_rset
            )
        return ReplicaRebuildReport(
            k=int(k),
            lam=float(lam),
            builds=builds,
            clusters=tuple(cluster_sigs),
            candidate_scanned=candidate_scanned,
            live_scanned=live_scanned,
            swapped=deployed is not None,
            old_generations=old_gens,
            new_generations=(
                deployed.generations() if deployed is not None else old_gens
            ),
            build_s=build_s,
            score_s=score_s,
        )


def _adopt_tree(tree: FrozenQdTree) -> LayoutBuild:
    """Wrap a pre-built FrozenQdTree as a minimal LayoutBuild artifact."""
    return LayoutBuild(
        tree=tree,
        bids=np.zeros(0, np.int32),
        strategy="adopted",
        build_s=0.0,
        metrics={"scanned_fraction": float("nan"), "n_leaves": tree.n_leaves},
        provenance={"strategy": "adopted"},
    )
