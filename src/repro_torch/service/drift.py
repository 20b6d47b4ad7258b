"""Drift-triggered auto-rebuild: the service watches its own Eq. 1 skip
rate and re-optimizes the layout when the workload shifts.

The paper's layout quality metric (Eq. 1 fraction of blocks scanned)
degrades silently when the data or query distribution drifts away from
what the live qd-tree was built for.  Online re-partitioning with bounded
regret (arXiv:2405.04984) and Lachesis' background re-optimization loop
(arXiv:2006.16529) both respond the same way: monitor, trigger, rebuild,
swap.  Three pieces close that loop over the existing lifecycle machinery:

* :class:`DriftMonitor` — folds per-batch :class:`~repro_torch.engine.WindowStat`
  observations (produced by ``LayoutEngine.ingest(observe=...)`` or the
  merged shard partials of ``sharded_ingest``) into a sliding window and
  applies a trigger policy: an absolute scanned-fraction threshold and/or
  degradation relative to the best window seen since the last rebaseline,
  with hysteresis (consecutive breaching windows required) and a cooldown
  after every trigger.  Pure and deterministic: the same observation
  sequence always yields the same decisions.
* :class:`RecordReservoir` — a bounded ring of the most recent ingested
  records, the corpus an auto-rebuild trains on.
* :class:`AutoRebuilder` — ties monitor + reservoir to a
  :class:`~repro_torch.service.service.LayoutService`: when the monitor trips it
  fires ``service.rebuild(reservoir, workload, swap="if_better")`` on a
  background executor.  Deployment goes through the service's existing
  compare-and-swap, so a concurrent rebuild (another trigger, an operator
  ``rebuild``) can never double-swap on the same baseline; an in-flight
  latch keeps the rebuilder itself single-shot until the running rebuild
  resolves.

``LayoutService.ingest(batches, monitor=rebuilder)`` and
``ingest_sharded(..., monitor=rebuilder)`` wire the accounting in; see
``benchmarks/drift_rebuild.py`` for the mid-stream workload shift this
machinery is built to absorb.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Executor, ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.engine.engine import WindowStat


# ---------------------------------------------------------------------------
# Trigger policy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Sliding-window trigger policy for :class:`DriftMonitor`.

    window          sliding window length, in observations (per-batch
                    WindowStats for single-stream ingest, one merged stat
                    per ``ingest_sharded`` run).
    min_fill        observations required in the window before any
                    trigger can fire (warm-up).
    abs_threshold   trigger when the window's Eq. 1 scanned fraction
                    exceeds this (None disables the absolute rule).
    rel_degradation trigger when the window rate exceeds
                    ``best_seen * (1 + rel_degradation)`` where
                    ``best_seen`` is the lowest window rate since the
                    last rebaseline (None disables the relative rule).
    hysteresis      consecutive breaching observations required before a
                    trigger fires (debounces single noisy batches).
    cooldown        observations after a trigger (or rebaseline) during
                    which no new trigger may fire — gives the rebuild
                    time to land and the window time to refill with
                    post-swap observations.
    """

    window: int = 16
    min_fill: int = 4
    abs_threshold: Optional[float] = None
    rel_degradation: Optional[float] = 0.5
    hysteresis: int = 2
    cooldown: int = 16

    def __post_init__(self):
        if self.window < 1:
            raise ValueError("window must be >= 1")
        if not 1 <= self.min_fill <= self.window:
            raise ValueError("min_fill must be in [1, window]")
        if self.hysteresis < 1:
            raise ValueError("hysteresis must be >= 1")
        if self.cooldown < 0:
            raise ValueError("cooldown must be >= 0")
        if self.abs_threshold is None and self.rel_degradation is None:
            raise ValueError(
                "at least one of abs_threshold / rel_degradation required"
            )


@dataclasses.dataclass(frozen=True)
class DriftDecision:
    """Outcome of one :meth:`DriftMonitor.observe` step."""

    triggered: bool
    reason: str  # "" | "abs" | "rel" | "abs+rel" | "cooldown" | "warmup"
    window_rate: float  # Eq. 1 scanned fraction over the current window
    best_rate: float  # best (lowest) window rate since last rebaseline
    breaches: int  # current consecutive-breach count (hysteresis state)
    cooldown_left: int
    observations: int  # total observations since construction


class DriftMonitor:
    """Online skip-rate monitor with hysteresis + cooldown (deterministic).

    Not thread-safe by itself — :class:`AutoRebuilder` serializes calls;
    drive it directly only from one thread.
    """

    def __init__(self, config: Optional[DriftConfig] = None):
        self.config = config or DriftConfig()
        self._window: deque[WindowStat] = deque(maxlen=self.config.window)
        # exact int running totals (subtract-on-evict is lossless on ints)
        self._totals = WindowStat()
        self._best: Optional[float] = None
        self._breaches = 0
        self._cooldown_left = 0
        self._observations = 0

    # -- state ---------------------------------------------------------------
    @property
    def window_stat(self) -> WindowStat:
        """Exact totals over the current window (shard-merge comparable)."""
        return self._totals

    @property
    def window_rate(self) -> float:
        return self._totals.scanned_fraction

    @property
    def best_rate(self) -> float:
        return self._best if self._best is not None else float("nan")

    @property
    def observations(self) -> int:
        return self._observations

    # -- the policy ----------------------------------------------------------
    def observe(self, stat: WindowStat) -> DriftDecision:
        """Fold one observation; decide whether a rebuild should fire."""
        cfg = self.config
        if len(self._window) == cfg.window:
            evicted = self._window[0]
            self._totals = WindowStat(
                self._totals.scanned_tuples - evicted.scanned_tuples,
                self._totals.capacity - evicted.capacity,
                self._totals.n_records - evicted.n_records,
            )
        self._window.append(stat)
        self._totals = self._totals.merge(stat)
        self._observations += 1

        rate = self._totals.scanned_fraction
        filled = len(self._window) >= cfg.min_fill
        if filled and (self._best is None or rate < self._best):
            self._best = rate

        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._breaches = 0
            return self._decision(False, "cooldown", rate)
        if not filled:
            self._breaches = 0
            return self._decision(False, "warmup", rate)

        reasons = []
        if cfg.abs_threshold is not None and rate > cfg.abs_threshold:
            reasons.append("abs")
        if (
            cfg.rel_degradation is not None
            and self._best is not None
            and rate > self._best * (1.0 + cfg.rel_degradation)
        ):
            reasons.append("rel")
        if reasons:
            self._breaches += 1
        else:
            self._breaches = 0
        if self._breaches >= cfg.hysteresis:
            self._breaches = 0
            self._cooldown_left = cfg.cooldown
            return self._decision(True, "+".join(reasons), rate)
        return self._decision(False, "+".join(reasons), rate)

    def _decision(self, trig: bool, reason: str, rate: float) -> DriftDecision:
        return DriftDecision(
            triggered=trig,
            reason=reason,
            window_rate=rate,
            best_rate=self.best_rate,
            breaches=self._breaches,
            cooldown_left=self._cooldown_left,
            observations=self._observations,
        )

    def rebaseline(self) -> None:
        """Reset after a layout change: the old window and best-seen were
        measured against a tree that no longer serves.  Keeps the cooldown
        so the refilling window cannot immediately re-trigger."""
        self._window.clear()
        self._totals = WindowStat()
        self._best = None
        self._breaches = 0
        self._cooldown_left = self.config.cooldown


# ---------------------------------------------------------------------------
# Recent-record reservoir
# ---------------------------------------------------------------------------
class RecordReservoir:
    """Bounded ring of the most recent ingested records (thread-safe).

    Rebuilds train on what the service saw *lately* — a sliding corpus,
    not a uniform-over-history sample — so after a distribution shift the
    reservoir converges to post-shift data at ingest speed.  ``snapshot``
    returns rows oldest→newest, matching a contiguous slice of the
    stream.  The ring is host numpy (the builders read it); a batch that
    lies on a GPU is sliced there first, so only the rows that can
    survive (the last ``capacity``) are copied back.
    """

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._buf: Optional[np.ndarray] = None  # guarded by: self._lock
        self._write = 0  # guarded by: self._lock -- next write position
        self._size = 0  # guarded by: self._lock
        self._seen = 0  # guarded by: self._lock

    def __len__(self) -> int:
        with self._lock:
            return self._size

    @property
    def records_seen(self) -> int:
        with self._lock:
            return self._seen

    def add(self, records) -> None:
        """Append a batch (numpy, or a tensor on any device)."""
        if records.shape[0] == 0:
            return
        rows = records[-self.capacity:]  # only the tail can survive
        if isinstance(rows, torch.Tensor):
            rows = rows.cpu().numpy()
        with self._lock:
            if self._buf is None:
                self._buf = np.empty(
                    (self.capacity,) + rows.shape[1:], rows.dtype
                )
            n = rows.shape[0]
            end = self._write + n
            if end <= self.capacity:
                self._buf[self._write:end] = rows
            else:
                split = self.capacity - self._write
                self._buf[self._write:] = rows[:split]
                self._buf[: end - self.capacity] = rows[split:]
            self._write = end % self.capacity
            self._size = min(self._size + n, self.capacity)
            self._seen += records.shape[0]

    def snapshot(self) -> np.ndarray:
        """Copy of the retained rows in arrival order (oldest first)."""
        with self._lock:
            if self._buf is None or self._size == 0:
                return np.zeros((0,), np.int32)
            if self._size < self.capacity:
                return self._buf[: self._size].copy()
            return np.concatenate(
                [self._buf[self._write:], self._buf[: self._write]]
            )

    def clear(self) -> None:
        with self._lock:
            self._size = 0
            self._write = 0


# ---------------------------------------------------------------------------
# The auto-rebuild loop
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RebuildEvent:
    """One trigger's outcome, recorded in ``AutoRebuilder.events``."""

    observation: int  # monitor observation count at trigger time
    decision: DriftDecision
    report: object = None  # service.RebuildReport | None
    deployed: bool = False
    skipped: str = ""  # "" | "in_flight" | "empty_reservoir" | "empty_workload"
    error: str = ""
    wall_s: float = 0.0


class AutoRebuilder:
    """Fires ``LayoutService.rebuild`` when the drift monitor trips.

    Thread-safety: ``observe`` may be called from any ingest thread (the
    monitor is driven under an internal lock); at most one rebuild is in
    flight at a time (later triggers while one runs are recorded as
    ``skipped="in_flight"``), and deployment relies on the service's
    compare-and-swap so even external concurrent rebuilds can't
    double-swap on the same baseline.

    ``executor``: ``None`` → a private single-worker thread pool (created
    lazily, shut down by :meth:`close`); ``"sync"`` → rebuild inline in
    the observing thread (deterministic tests/benchmarks); otherwise any
    ``concurrent.futures`` executor.

    ``workload`` may be the string ``"auto"``: instead of a declared
    standing workload, drift accounting and rebuilds score against the
    live query mix a :class:`~repro_torch.service.tracker.WorkloadTracker`
    infers from the serving path — :meth:`current_workload` re-infers it
    at every ingest run and again at trigger time, so a rebuild optimizes
    for what users are asking *now*, not what an operator once declared.
    Pass ``tracker=`` (the tracker ``LayoutService.serve`` records into);
    omitted, one is created via ``service.workload_tracker()`` and
    exposed as ``rebuilder.tracker``.
    """

    def __init__(
        self,
        service,  # LayoutService (kept untyped: service imports this module)
        workload,  # qry.Workload | "auto" the monitor scores against
        config: Optional[DriftConfig] = None,
        reservoir: Optional[RecordReservoir] = None,
        reservoir_capacity: int = 65536,
        executor: Optional[Executor | str] = None,
        rebuild_kw: Optional[dict] = None,  # forwarded to service.rebuild
        on_event: Optional[Callable[[RebuildEvent], None]] = None,
        tracker=None,  # tracker.WorkloadTracker (workload="auto")
    ):
        self.service = service
        if isinstance(workload, str):
            if workload != "auto":
                raise ValueError(
                    f"workload must be a Workload or 'auto', got "
                    f"{workload!r}"
                )
            if tracker is None:
                tracker = service.workload_tracker()
        self.workload = workload  # guarded by: self._lock
        self.tracker = tracker  # guarded by: self._lock
        self.monitor = DriftMonitor(config)  # guarded by: self._lock
        self.reservoir = (
            reservoir
            if reservoir is not None
            else RecordReservoir(reservoir_capacity)
        )
        self.rebuild_kw = dict(rebuild_kw or {})
        self.rebuild_kw.setdefault("swap", "if_better")
        self.policy = None  # RebuildPolicy when built via from_policy
        self.on_event = on_event
        self.events: list[RebuildEvent] = []
        self._lock = threading.Lock()
        self._inflight: Optional[threading.Event] = None  # guarded by: self._lock
        self._executor = executor
        self._own_executor: Optional[ThreadPoolExecutor] = None

    @classmethod
    def from_policy(
        cls,
        service,
        policy,  # repro_torch.service.options.RebuildPolicy
        reservoir: Optional[RecordReservoir] = None,
        on_event: Optional[Callable[["RebuildEvent"], None]] = None,
    ) -> "AutoRebuilder":
        """Construct from a typed :class:`RebuildPolicy` (the
        consolidated ``auto_rebuilder`` surface).  A policy with
        ``replicas > 1`` makes triggered rebuilds deploy a k-replica
        set via ``service.rebuild_replicas`` (cheapest-replica routing,
        ``lam`` uniform-prior blend) instead of a single tree."""
        rb = cls(
            service,
            policy.workload,
            config=policy.drift,
            reservoir=reservoir,
            reservoir_capacity=policy.reservoir_capacity,
            executor=policy.executor,
            rebuild_kw=dict(policy.rebuild_kw or {}),
            on_event=on_event,
            tracker=policy.tracker,
        )
        rb.policy = policy
        return rb

    # -- stream plumbing -----------------------------------------------------
    def set_workload(self, workload, tracker=None) -> None:
        """Point the monitor (and future rebuilds) at a new standing
        workload (or ``"auto"`` + a tracker).  Deliberately does NOT
        rebaseline: the window should now show how badly the live tree
        serves the new queries — that degradation is exactly the drift
        signal."""
        if isinstance(workload, str) and workload != "auto":
            raise ValueError(
                f"workload must be a Workload or 'auto', got {workload!r}"
            )
        with self._lock:
            self.workload = workload
            if tracker is not None:
                self.tracker = tracker
            if workload == "auto" and self.tracker is None:
                self.tracker = self.service.workload_tracker()

    def current_workload(self):
        """The workload drift accounting and rebuilds score against *right
        now*: the declared one, or — with ``workload="auto"`` — the
        tracker-inferred live mix (re-inferred on every call; the tracker
        caches per version, so unchanged sketches cost nothing).  May be
        empty before any queries were served — callers skip observation
        then."""
        with self._lock:
            workload, tracker = self.workload, self.tracker
        if isinstance(workload, str):
            return tracker.infer_workload()
        return workload

    def tee(self, batches: Iterable) -> Iterator:
        """Pass batches through, copying each into the reservoir."""
        for batch in batches:
            self.reservoir.add(batch)
            yield batch

    def add_records(self, records) -> None:
        self.reservoir.add(records)

    # -- observation → trigger → rebuild -------------------------------------
    def observe(self, stat: WindowStat) -> DriftDecision:
        """Fold one observation; fire a background rebuild on trigger."""
        skip_ev = done = None
        with self._lock:
            decision = self.monitor.observe(stat)
            if decision.triggered:
                if self._inflight is not None:
                    skip_ev = RebuildEvent(
                        observation=decision.observations,
                        decision=decision,
                        skipped="in_flight",
                    )
                else:
                    done = threading.Event()
                    self._inflight = done
        # record/fire outside the lock: on_event callbacks may call back
        # into the rebuilder (drain, observe) without deadlocking
        if skip_ev is not None:
            self._record(skip_ev)
        if done is not None:
            if self._executor == "sync":
                self._run_rebuild(decision, done)
            else:
                self._pool().submit(self._run_rebuild, decision, done)
        return decision

    def _pool(self) -> Executor:
        if isinstance(self._executor, Executor):
            return self._executor
        if self._own_executor is None:
            self._own_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="drift-rebuild"
            )
        return self._own_executor

    def _run_rebuild(
        self, decision: DriftDecision, done: threading.Event
    ) -> None:
        ev = RebuildEvent(
            observation=decision.observations, decision=decision
        )
        t0 = time.perf_counter()
        try:
            records = self.reservoir.snapshot()
            if records.shape[0] == 0:
                ev.skipped = "empty_reservoir"
                return
            # resolved at trigger time: an "auto" rebuild optimizes for
            # the mix the tracker is seeing NOW, not at construction
            workload = self.current_workload()
            if workload is not None and len(workload) == 0:
                ev.skipped = "empty_workload"
                return
            policy = self.policy
            if policy is not None and policy.replicas > 1:
                # replica policy: the triggered rebuild deploys a whole
                # k-replica set clustered from the tracked mix
                with self._lock:
                    tracker = (
                        self.tracker
                        if isinstance(self.workload, str)
                        else None
                    )
                report = self.service.rebuild_replicas(
                    records,
                    workload=workload,
                    k=policy.replicas,
                    lam=policy.lam,
                    tracker=tracker,
                    **self.rebuild_kw,
                )
            else:
                report = self.service.rebuild(
                    records, workload, **self.rebuild_kw
                )
            ev.report = report
            ev.deployed = bool(report.swapped)
            if report.swapped:
                # new live layout: the window/best-seen measured the old
                # one — restart the baseline (cooldown keeps the refill
                # from immediately re-triggering)
                with self._lock:
                    self.monitor.rebaseline()
        except Exception as e:  # surfaced via events, never kills ingest
            ev.error = f"{type(e).__name__}: {e}"
        finally:
            ev.wall_s = time.perf_counter() - t0
            with self._lock:
                self._inflight = None
            self._record(ev)  # outside the lock: see observe()
            done.set()

    def _record(self, ev: RebuildEvent) -> None:
        self.events.append(ev)
        if self.on_event is not None:
            self.on_event(ev)

    # -- lifecycle -----------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until the in-flight rebuild (if any) resolves."""
        with self._lock:
            pending = self._inflight
        return pending.wait(timeout) if pending is not None else True

    @property
    def rebuilds_deployed(self) -> int:
        return sum(1 for e in self.events if e.deployed)

    def close(self) -> None:
        self.drain()
        if self._own_executor is not None:
            self._own_executor.shutdown(wait=True)
            self._own_executor = None

    def __enter__(self) -> "AutoRebuilder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = [
    "AutoRebuilder",
    "DriftConfig",
    "DriftDecision",
    "DriftMonitor",
    "RebuildEvent",
    "RecordReservoir",
]
