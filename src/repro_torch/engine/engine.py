"""LayoutEngine: the single serving interface over a frozen qd-tree.

    eng = LayoutEngine(frozen_tree)              # backend "torch", the GPU
    bids = eng.route(records)                    # route_descend
    report = eng.ingest(batch_iter)              # fused_ingest per batch
    eng.ingest(batch_iter, buffers=BlockBuffers.for_tree(tree))  # + spill
    hits = eng.query_hits(workload)              # (n_leaves, n_queries) bool
    lists = eng.route_queries(workload)          # per-query BID IN (...) lists
    stats = eng.skip_stats(records, workload)    # paper Eq. 1 metrics

The engine runs on the GPU unless it is given ``device="cpu"``, where the
torch backend takes the kernels' plain versions.  Records may be numpy
arrays (copied to the device) or int32 tensors already on it.  Both
backends are bit-identical; the torch backend's packed operands are
cached per tree in the plan cache, and ``eng.stats()`` exposes the
plan-cache, plan-build and kernel-launch counters.
"""

from __future__ import annotations

# qdlint: deterministic-module

import collections
import dataclasses
import threading
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import query as qry
from repro_torch.core.qdtree import FrozenQdTree, IncrementalTightener
from repro_torch.engine import backends as be
from repro_torch.engine import plan as planlib
from repro_torch.engine.plan import PlanCache
from repro_torch.kernels import _build


@dataclasses.dataclass(frozen=True)
class WindowStat:
    """Associative Eq. 1 accounting partial over one or more batches.

    ``scanned_tuples`` is the paper's Σ_q Σ_{P ∩ q} |P| restricted to the
    observed records; ``capacity`` the matching denominator
    Σ_batches (n_records · n_queries).  All fields are exact Python ints,
    so :meth:`merge` (elementwise sum) is associative and commutative.
    """

    scanned_tuples: int = 0
    capacity: int = 0  # Σ n_records * n_queries over observed batches
    n_records: int = 0

    @property
    def scanned_fraction(self) -> float:
        """Eq. 1 fraction of tuples the standing workload would scan."""
        return self.scanned_tuples / self.capacity if self.capacity else 0.0

    def merge(self, other: "WindowStat") -> "WindowStat":
        return WindowStat(
            scanned_tuples=self.scanned_tuples + other.scanned_tuples,
            capacity=self.capacity + other.capacity,
            n_records=self.n_records + other.n_records,
        )

    def to_array(self) -> np.ndarray:
        return np.asarray(
            [self.scanned_tuples, self.capacity, self.n_records], np.int64
        )

    @staticmethod
    def from_array(a: np.ndarray) -> "WindowStat":
        return WindowStat(*(int(x) for x in a))


@dataclasses.dataclass(frozen=True)
class ObservationProbe:
    """Per-leaf hit accounting against one standing workload.

    ``per_leaf[b]`` is the number of queries whose ``BID IN (...)`` list
    contains block ``b`` — ``query_hits(workload).sum(axis=1)`` computed
    once.  ``on_device`` holds the same counts as an int64 tensor on the
    engine's GPU (None on the CPU): a batch whose block ids stay on that
    device is then scored by a gather and a sum there, and only the sum
    comes back; numpy ids take the host gather.  Both are exact integer
    sums.  Pickling drops the device copy (process shards score on the
    host form).
    """

    per_leaf: np.ndarray  # (n_leaves,) int64 queries scanning each block
    n_queries: int
    on_device: Optional[torch.Tensor] = dataclasses.field(
        default=None, compare=False, repr=False
    )

    def __reduce__(self):
        return (ObservationProbe, (self.per_leaf, self.n_queries))

    def observe(self, bids) -> WindowStat:
        """Eq. 1 partial for one routed batch (numpy ids or a tensor)."""
        m = int(bids.shape[0])
        if isinstance(bids, torch.Tensor):
            if self.on_device is None or self.on_device.device != bids.device:
                raise ValueError(
                    f"probe has no per-leaf counts on {bids.device}"
                )
            scanned = int(self.on_device.index_select(0, bids).sum())
        else:
            scanned = int(self.per_leaf[bids].sum())
        return WindowStat(
            scanned_tuples=scanned,
            capacity=m * self.n_queries,
            n_records=m,
        )


@dataclasses.dataclass
class IngestReport:
    """Summary of one streaming-ingestion run."""

    n_batches: int
    n_records: int
    block_sizes: np.ndarray  # (n_leaves,) records routed per block
    wall_s: float
    backend: str
    plan_cache: dict  # hits/misses/size snapshot
    builds: dict  # plan-build counter deltas during the run
    observation: Optional[WindowStat] = None  # set iff ``observe`` was given
    fused: bool = False  # True when the single-pass route+tighten path ran

    @property
    def records_per_s(self) -> float:
        return self.n_records / self.wall_s if self.wall_s else 0.0


class WorkloadTensorCache(collections.OrderedDict):
    """LRU of tensorized workloads with its own lock.

    Concurrent query threads interleave get / move_to_end / popitem — the
    lock keeps the multi-step LRU update atomic.  Tensorization itself
    runs outside it.
    """

    def __init__(self):
        super().__init__()
        self.lock = threading.Lock()


class LayoutEngine:
    """Backend-dispatched routing/query API with a plan cache."""

    WT_CACHE_CAP = 16  # live workload-tensor entries kept per engine

    def __init__(
        self,
        tree: FrozenQdTree,
        backend: str = "torch",
        device=None,
        plan_cache: Optional[PlanCache] = None,
        wt_cache: Optional[WorkloadTensorCache] = None,
    ):
        be.get_backend(backend)  # validate eagerly
        self.tree = tree
        self.backend = backend
        self.device = planlib.resolve_device(device)
        self.plans = plan_cache if plan_cache is not None else PlanCache()
        # LRU of tensorized workloads, keyed by (cut-table content
        # signature, workload id); values keep a strong reference to the
        # workload, so its id() cannot be reused while the entry lives
        self._wt_cache: WorkloadTensorCache = (
            wt_cache if wt_cache is not None else WorkloadTensorCache()
        )

    # -- dispatch -----------------------------------------------------------
    def _backend(self, override: Optional[str]) -> be.Backend:
        return be.get_backend(override or self.backend)

    # -- routing ------------------------------------------------------------
    def route(  # qdlint: hot-path
        self, records, backend: Optional[str] = None
    ) -> np.ndarray:
        """Record batch → (m,) int32 BIDs (paper Sec 3.1)."""
        if records.shape[0] == 0:
            return np.zeros(0, np.int32)
        return self._backend(backend).route(
            self.tree, self.plans, records, self.device
        )

    # -- query processing ---------------------------------------------------
    def _tensorize(
        self, workload: qry.Workload | qry.WorkloadTensors
    ) -> qry.WorkloadTensors:
        if isinstance(workload, qry.WorkloadTensors):
            return workload
        key = (planlib.cuts_signature(self.tree.cuts), id(workload))
        with self._wt_cache.lock:
            hit = self._wt_cache.get(key)
            if hit is not None and hit[0] is workload:
                self._wt_cache.move_to_end(key)
                return hit[1]
        wt = workload.tensorize(self.tree.cuts)  # expensive: outside lock
        with self._wt_cache.lock:
            self._wt_cache[key] = (workload, wt)
            self._wt_cache.move_to_end(key)
            while len(self._wt_cache) > self.WT_CACHE_CAP:
                self._wt_cache.popitem(last=False)  # evict LRU entry
        return wt

    def query_hits(  # qdlint: hot-path
        self,
        workload: qry.Workload | qry.WorkloadTensors,
        backend: Optional[str] = None,
    ) -> np.ndarray:
        """(n_leaves, n_queries) bool — blocks each query must scan."""
        return self._backend(backend).query_hits(
            self.tree, self.plans, self._tensorize(workload), self.device
        )

    def route_queries(  # qdlint: hot-path
        self,
        workload: qry.Workload | qry.WorkloadTensors,
        backend: Optional[str] = None,
        track=None,  # service.tracker.WorkloadTracker | None
    ) -> list[np.ndarray]:
        """Per-query BID IN (...) lists for a whole workload (Sec 3.3).

        One tensorization and one ``query_hits`` dispatch serve every
        query.  ``track`` records each served query's canonical predicate
        signature into the given
        :class:`~repro_torch.service.tracker.WorkloadTracker` (host numpy:
        no dispatch, no plan-cache traffic).
        """
        wt = self._tensorize(workload)
        if track is not None:
            track.record(workload, cuts=self.tree.cuts)
        hits = self.query_hits(wt, backend=backend)
        return [
            np.nonzero(hits[:, q])[0].astype(np.int32)
            for q in range(wt.n_queries)
        ]

    def route_query(
        self, query: qry.Query, backend: Optional[str] = None, track=None
    ) -> np.ndarray:
        """BID IN (...) list for one query — 1-query ``route_queries``.

        Dispatches like every other entry point (on the GPU: one
        ``query_intersect`` launch) and tensorizes directly, bypassing the
        workload LRU.  ``track`` records the query as ``route_queries``
        does.
        """
        wl = qry.Workload(self.tree.schema, (query,))
        if track is not None:
            track.record(wl, cuts=self.tree.cuts)
        return self.route_queries(
            wl.tensorize(self.tree.cuts), backend=backend
        )[0]

    def skip_stats(
        self,
        records,
        workload: qry.Workload | qry.WorkloadTensors,
        tighten: bool = True,
        backend: Optional[str] = None,
    ):
        """Route + (optionally) tighten + score: paper Eq. 1 SkipStats.

        With ``tighten`` the batch goes through one ``fused_step`` and its
        partial is applied — bit-identical to routing, then
        ``FrozenQdTree.tighten``.
        """
        from repro_torch.core import rewards

        if tighten:
            bids, part = self.fused_step(records, backend=backend)
            t = IncrementalTightener(self.tree)
            t.merge(part)
            t.apply()
        else:
            bids = self.route(records, backend=backend)
        sizes = np.bincount(bids, minlength=self.tree.n_leaves).astype(
            np.int64
        )
        wt = self._tensorize(workload)
        hits, conj_scanned = self._backend(backend).query_intersect(
            self.tree, self.plans, wt, self.device
        )
        scanned = int((hits * sizes[:, None]).sum())
        total = records.shape[0] * wt.n_queries
        return rewards.SkipStats(
            n_records=records.shape[0],
            n_queries=wt.n_queries,
            n_blocks=self.tree.n_leaves,
            scanned_tuples=scanned,
            skipped_tuples=total - scanned,
            block_sizes=sizes,
            query_hits=hits,
            conj_scanned=conj_scanned,
        )

    # -- streaming ingestion -------------------------------------------------
    def fused_step(  # qdlint: hot-path
        self, records, backend: Optional[str] = None, return_bids: bool = True
    ):
        """One single-pass route + tighten step (no tree mutation).

        Returns ``(bids int32 (m,) | None, TightenPartial)`` — bit-identical
        to :meth:`route` followed by ``IncrementalTightener.update`` over
        the same records, but each record is read once.  The caller folds
        the partial into a tightener (``merge``).
        """
        if records.shape[0] == 0:
            return (
                np.zeros(0, np.int32) if return_bids else None,
                IncrementalTightener(self.tree).as_partial(),
            )
        return self._backend(backend).fused_ingest(
            self.tree, self.plans, records, self.device,
            return_bids=return_bids,
        )

    def warm_ingest(
        self, sizes: Iterable[int], backend: Optional[str] = None
    ) -> None:
        """Build the ingest plan (and load the kernels) before data arrives.

        Routes zero-filled batches of these sizes through
        :meth:`fused_step`; the tree is never mutated (the partials are
        discarded).
        """
        d = self.tree.leaf_lo.shape[1]
        for s in sorted({int(s) for s in sizes if int(s) > 0}):
            self.fused_step(np.zeros((s, d), np.int32), backend=backend,
                            return_bids=False)

    def observation_probe(
        self,
        workload: "qry.Workload | qry.WorkloadTensors | ObservationProbe",
        backend: Optional[str] = None,
    ) -> ObservationProbe:
        """Per-leaf hit counts for ``workload`` against the current layout,
        on the host and, for an engine on a GPU, on its device too."""
        if isinstance(workload, ObservationProbe):
            probe = workload
        else:
            hits = self.query_hits(workload, backend=backend)
            probe = ObservationProbe(
                per_leaf=hits.sum(axis=1).astype(np.int64),
                n_queries=int(hits.shape[1]),
            )
        if self.device.type != "cuda" or (
            probe.on_device is not None
            and probe.on_device.device == self.device
        ):
            return probe
        return dataclasses.replace(
            probe, on_device=torch.from_numpy(probe.per_leaf).to(self.device)
        )

    def ingest(
        self,
        batches: Iterable | Iterator,
        tighten: bool = True,
        buffers=None,  # data.blocks.BlockBuffers | None
        backend: Optional[str] = None,
        observe=None,  # Workload | WorkloadTensors | ObservationProbe | None
        on_observation=None,  # Callable[[WindowStat], None] | None
        fused: bool = True,
    ) -> IngestReport:
        """Route arriving micro-batches and fold them into the layout.

        Per batch: route → append to ``buffers`` (if given) → incrementally
        min-max-tighten the leaf descriptions, exactly equivalent to
        one-shot tightening over the concatenation of all batches
        (min/max/any are associative).  A tensor batch spills with its
        block ids kept on its device, where ``BlockBuffers.append`` sorts
        it; only a spill buffer or an observation asks the fold for block
        ids at all, so a plain ingest still copies back once.

        ``fused=True`` (the default) takes the single-pass path: each
        batch is folded into the backend's running accumulator (on the
        torch backend one ``fused_ingest`` launch a batch, the aggregates
        kept on the device), and after the last batch its one partial is
        merged into the tightener; ``fused=False`` routes, then tightens
        on the host.  With
        ``observe``, every batch is also scored against the workload's
        per-leaf hit counts (Eq. 1 restricted to the batch) and the
        :class:`WindowStat` goes to ``on_observation``; the run's total
        lands in ``IngestReport.observation``.
        """
        builds0 = planlib.build_counts()
        probe = (
            self.observation_probe(observe, backend=backend)
            if observe is not None
            else None
        )
        observed = WindowStat() if probe is not None else None
        tightener = IncrementalTightener(self.tree) if tighten else None
        sizes = None if tighten else np.zeros(self.tree.n_leaves, np.int64)
        use_fused = fused and tightener is not None
        need_bids = buffers is not None or probe is not None
        # the ids stay on the device for a spill of tensor batches, and for
        # an observation the probe scores there (only its sum comes back)
        device_probe = probe is not None and probe.on_device is not None
        n_batches = n_records = 0
        t0 = time.perf_counter()
        acc = (
            self._backend(backend).accumulator(self.tree, self.plans,
                                               self.device)
            if use_fused else None
        )
        for batch in batches:
            if batch.shape[0] == 0:
                continue
            if use_fused:
                bids = acc.fold(
                    batch, return_bids=need_bids,
                    on_device=(device_probe and buffers is None) or (
                        buffers is not None
                        and not isinstance(batch, np.ndarray)),
                )
            else:
                bids = self.route(batch, backend=backend)
                if tightener is not None:
                    tightener.update(be.as_host(batch), bids)
                else:
                    sizes += np.bincount(bids, minlength=sizes.shape[0])
            if buffers is not None:
                buffers.append(batch, bids)
            if probe is not None:
                stat = probe.observe(bids if device_probe else be.as_host(bids))
                observed = observed.merge(stat)
                if on_observation is not None:
                    on_observation(stat)
            n_batches += 1
            n_records += batch.shape[0]
        if use_fused:
            tightener.merge(acc.partial())
        if tightener is not None:
            tightener.apply()
            sizes = tightener.counts.copy()
        wall = time.perf_counter() - t0
        return IngestReport(
            n_batches=n_batches,
            n_records=n_records,
            block_sizes=sizes,
            wall_s=wall,
            backend=backend or self.backend,
            plan_cache=self.plans.stats(),
            builds=planlib.build_delta(builds0, planlib.build_counts()),
            observation=observed,
            fused=use_fused,
        )

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        return {
            "backend": self.backend,
            "device": str(self.device),
            "plan_cache": self.plans.stats(),
            "builds": planlib.build_counts(),
            "launches": _build.launch_counts(),
        }


def engine_for(
    tree: FrozenQdTree, backend: str = "torch", **kw
) -> LayoutEngine:
    """The tree's attached engine (created on first use).

    Attaching keeps the plan cache alive across the free-function
    callsites (``routing.route``, ``query.route_query``,
    ``rewards.evaluate_layout``).
    """
    eng = getattr(tree, "_layout_engine", None)
    if eng is None:
        eng = LayoutEngine(tree, backend=backend, **kw)
        object.__setattr__(tree, "_layout_engine", eng)
    return eng
