"""QueryServer: the serving tier's front door over a LayoutService.

Request flow (one dispatch):

    submit ──admission──▶ RequestQueue ──size-or-deadline──▶ _dispatch
        capture live replica set ──▶ one Epoch per replica
        exact signatures ──▶ cache.lookup across the live epochs
        misses (deduped by signature) ──▶ route: ONE route_queries
            dispatch per replica, cheapest replica per query (Eq. 1
            block counts) — a single-replica set degrades to exactly
            one dispatch on the primary engine
        cache.put per unique miss under the CHOSEN replica's epoch
        tracker.record(hits + misses) + tick
        complete tickets (latency, provenance epoch, staleness audit)

Soundness protocol (the worst-case framing of arXiv 2405.04984 — never
serve block IDs from a retired layout):

* the live :class:`~repro_torch.service.replica.ReplicaSet` is read ONCE per
  dispatch attempt; epochs, signatures, cache traffic, and routing all
  use that single capture, so a concurrent hot swap cannot mix
  generations within one dispatch;
* under k > 1 replicas, cache keys use signatures built from the UNION
  of every replica's cut-visible advanced atoms — equal keys then imply
  an identical tensorized form on *every* replica, hence an identical
  cheapest-replica choice, so a hit can never alias two queries that
  would have been routed to different replicas;
* a swap *during* routing is harmless for delivery — the outgoing tree is
  never mutated by a swap, so the routed lists stay bit-identical for
  their generation, and a response is only *stale* if its generation was
  retired before the request was submitted (which cannot happen: dispatch
  always routes the version live at-or-after submit) — but the results
  are NOT cached (and :meth:`ResultCache.put` would reject them anyway
  once the next dispatch re-activates the new epoch);
* in-place tightening (``desc_version`` bump) DOES mutate the live tree,
  so a mid-route bump could yield torn results: the dispatcher re-checks
  the description version after routing and re-dispatches
  (``swap_retries``) against the settled epoch.

Cache hits still record into the :class:`WorkloadTracker` — one
``tracker.record`` per dispatch covers hit and miss queries alike, so
workload inference (and the drift rebuilds it feeds) never goes blind to
cached traffic.

A miss batch is an ephemeral workload: its conjuncts are packed and
uploaded for that one dispatch (``route_queries(transient=True)``) and
never enter the service's plan cache, so serving builds no plan and never
evicts the operands of the standing workloads (the service's declared
workload, the drift monitor's, the observation probe's).  On the card a
dispatch is one ``query_intersect`` launch per replica engine; the only
plan it reads is each tree's leaf descriptions, which :meth:`QueryServer.warm`
builds up front.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterable, Optional

import numpy as np

from repro_torch.core import query as qry
from repro_torch.engine import plan as planlib
from repro_torch.serve.cache import Epoch, ResultCache, exact_signatures
from repro_torch.serve.coalescer import (
    QueryTicket,
    RequestQueue,
    ServeConfig,
    ServeResult,
)
from repro_torch.serve.stats import LatencyRecorder


@dataclasses.dataclass
class ServerCounters:
    """Monotonic dispatch-loop counters (all pinnable by tests — no timings)."""

    dispatches: int = 0  # coalesced batches processed
    engine_dispatches: int = 0  # route_queries calls (miss batches)
    queries_served: int = 0
    queries_cached: int = 0  # answered from the result cache
    queries_routed: int = 0  # unique-signature misses routed by the engine
    swap_retries: int = 0  # re-dispatches after a mid-route epoch move
    uncached_dispatches: int = 0  # delivered-but-not-cached miss batches
    stale_responses: int = 0  # the invariant counter: must stay 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class QueryServer:
    """Admission + coalescing + semantic result cache over a LayoutService.

    Two operating modes share one dispatch core:

    * **async** — :meth:`start` spawns a dispatcher thread; callers
      :meth:`submit` and block on the returned ticket.  This is the
      closed-loop serving mode the benchmark drives for timings.
    * **sync** — without :meth:`start`, :meth:`serve_batch` admits a
      burst and drains the queue inline on the calling thread: fully
      deterministic (no thread scheduling in the counters), which is what
      the tests pin.

    The server subscribes to the service's swap notifications so the
    result cache invalidates the moment a new generation goes live,
    rather than at the next dispatch.
    """

    def __init__(
        self,
        service,
        config: Optional[ServeConfig] = None,
        tracker=None,
        clock=time.monotonic,
    ):
        self.service = service
        self.config = config if config is not None else ServeConfig()
        self.tracker = tracker
        self.clock = clock
        self.queue = RequestQueue(self.config, clock=clock)
        self.cache = ResultCache(self.config.cache_capacity)
        self.latency = LatencyRecorder()
        self.counters = ServerCounters()
        self._mutate = threading.Lock()  # counters only
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.cache.activate(service.live_epochs())
        service.subscribe(self._on_swap)

    @staticmethod
    def _epoch_of(live) -> Epoch:
        return Epoch(
            live.generation,
            planlib.desc_version(live.tree),
            getattr(live, "replica_id", 0),
        )

    def _on_swap(self, version) -> None:
        # prompt hygiene purge; soundness never depends on it (lookups key
        # on the epoch captured per dispatch)
        self.cache.activate(self._epoch_of(version))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "QueryServer":
        """Spawn the background dispatcher thread (idempotent)."""
        if self._running:
            return self
        if self._closed:
            raise RuntimeError("server already stopped")
        self._running = True
        self._thread = threading.Thread(
            target=self._loop, name="qd-serve-dispatch", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop admitting, drain the dispatcher, fail undispatched tickets."""
        if self._closed:
            return
        self._closed = True
        self._running = False
        drained = self.queue.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err = RuntimeError("server stopped before dispatch")
        for t in drained:
            if not t.done():
                t._fail(err)
                self.queue.release(t)
        self.service.unsubscribe(self._on_swap)

    def __enter__(self) -> "QueryServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while self._running:
            batch = self.queue.next_batch(timeout=0.05)
            if batch:
                self._dispatch(batch)

    # -- request API ---------------------------------------------------------
    def submit(
        self, query: qry.Query, tenant: str = "default"
    ) -> QueryTicket:
        """Admit one query (raises AdmissionError when bounds are hit)."""
        ticket = self.queue.submit(query, tenant)
        ticket.generation_at_submit = self.service.generation
        ticket.gens_at_submit = self.service.replica_generations()
        return ticket

    def serve(
        self,
        query: qry.Query,
        tenant: str = "default",
        timeout: Optional[float] = None,
    ) -> ServeResult:
        """Submit one query and block for its result (sync convenience)."""
        ticket = self.submit(query, tenant)
        if not self._running:
            self.flush()
        return ticket.result(timeout)

    def serve_batch(
        self, queries: Iterable[qry.Query], tenant: str = "default"
    ) -> list[ServeResult]:
        """Admit a burst and drain it inline — the deterministic path.

        With no dispatcher thread running, every dispatch happens on the
        calling thread in admission order, so cache hit/miss counters are
        exactly reproducible (this is what the tests pin).  Safe with a
        running dispatcher too; tickets then complete on either thread.
        """
        # admit without enqueueing: the batch is already formed, so the
        # coalescing deque round-trip would be pure overhead — dispatch
        # the admitted tickets directly in max_batch chunks (the same
        # geometry next_batch would have produced)
        tickets = self.queue.submit_many(queries, tenant, enqueue=False)
        gen = self.service.generation
        gens = self.service.replica_generations()
        for t in tickets:
            t.generation_at_submit = gen
            t.gens_at_submit = gens
        mb = self.config.max_batch
        for i in range(0, len(tickets), mb):
            self._dispatch(tickets[i:i + mb])
        self.flush()  # drain anything submitted concurrently
        return [t.result() for t in tickets]

    def flush(self) -> int:
        """Drain pending requests on the calling thread; returns batches."""
        n = 0
        while True:
            batch = self.queue.next_batch(timeout=0)
            if not batch:
                return n
            self._dispatch(batch)
            n += 1

    def warm(self, sample: qry.Workload) -> None:
        """Build EVERY live replica's query plan (its leaf descriptions on
        the device) and load the kernel, by one transient dispatch per
        coalesced dispatch geometry (power-of-two batch sizes up to
        ``max_batch``, queries drawn from ``sample``), so steady-state
        serving builds ZERO plans — call after construction and after each
        hot swap (plan builds are swap cost, not serve cost).  The replica
        router routes the same miss batch on every replica, so each
        replica engine needs its own plan.
        """
        rset = self.service.live_replica_set()
        if not len(sample):
            return
        sizes = []
        n = 1
        while n < self.config.max_batch:
            sizes.append(n)
            n *= 2
        sizes.append(self.config.max_batch)
        for n in sizes:
            wl = qry.Workload(
                sample.schema,
                tuple(
                    sample.queries[i % len(sample.queries)]
                    for i in range(n)
                ),
            )
            for v in rset.versions:
                v.engine.query_hits(wl.tensorize(v.tree.cuts),
                                    transient=True)

    # -- the dispatch core ---------------------------------------------------
    def _dispatch(self, tickets: list[QueryTicket]) -> None:
        if not tickets:
            return
        cfg = self.config
        try:
            for attempt in range(cfg.max_swap_retries + 1):
                rset = self.service.live_replica_set()
                live = rset.primary
                epochs = rset.epochs()
                self.cache.activate(epochs)
                wl_all = qry.Workload(
                    live.tree.schema, tuple(t.query for t in tickets)
                )
                if rset.k == 1:
                    sigs = exact_signatures(wl_all, live.tree.cuts)
                else:
                    sigs = exact_signatures(
                        wl_all, adv_filter=rset.adv_filter()
                    )
                found = self.cache.lookup(epochs, sigs)
                miss_index: dict[tuple, int] = {}
                miss_queries: list[qry.Query] = []
                for t, sig, h in zip(tickets, sigs, found):
                    if h is None and sig not in miss_index:
                        miss_index[sig] = len(miss_queries)
                        miss_queries.append(t.query)
                routed: list[np.ndarray] = []
                miss_epochs: list[Epoch] = []
                if miss_queries:
                    miss_wl = qry.Workload(
                        live.tree.schema, tuple(miss_queries)
                    )
                    if rset.k == 1:
                        # tensorize against the captured tree's cuts
                        # directly: one dispatch per miss batch, no
                        # wt-LRU or plan-cache churn from ephemeral
                        # per-batch workload objects
                        routed = live.engine.route_queries(
                            miss_wl.tensorize(live.tree.cuts),
                            transient=True,
                        )
                        miss_epochs = [epochs[0]] * len(routed)
                        n_dispatches = 1
                    else:
                        routes = rset.route_queries(miss_wl,
                                                    transient=True)
                        routed = [r.bids for r in routes]
                        miss_epochs = [epochs[r.replica_id]
                                       for r in routes]
                        n_dispatches = rset.k
                    with self._mutate:
                        self.counters.engine_dispatches += n_dispatches
                        self.counters.queries_routed += len(miss_queries)
                    # a desc_version bump mid-route means some tree's
                    # leaf descriptions were tightened UNDER the
                    # dispatch — results may be torn: re-dispatch
                    torn = any(
                        planlib.desc_version(v.tree) != e.desc_version
                        for v, e in zip(rset.versions, epochs)
                    )
                    if torn:
                        if attempt < cfg.max_swap_retries:
                            with self._mutate:
                                self.counters.swap_retries += 1
                            continue
                swapped = self.service.live_replica_set() is not rset
                torn_now = any(
                    planlib.desc_version(v.tree) != e.desc_version
                    for v, e in zip(rset.versions, epochs)
                )
                if miss_queries and (swapped or torn_now):
                    # deliverable (old trees are immutable across a swap)
                    # but the epoch is retired — never cache retired
                    # results
                    with self._mutate:
                        self.counters.uncached_dispatches += 1
                else:
                    for sig, i in miss_index.items():
                        self.cache.put(miss_epochs[i], sig, routed[i])
                self._record(wl_all, live)
                self._complete(tickets, sigs, found, routed, miss_index,
                               miss_epochs)
                return
        except BaseException as e:
            for t in tickets:
                if not t.done():
                    t._fail(e)
                    self.queue.release(t)

    def _record(self, wl_all: qry.Workload, live) -> None:
        """Tracker observation: hits and misses alike, one round per
        ``tick_every`` dispatches."""
        with self._mutate:
            self.counters.dispatches += 1
            n = self.counters.dispatches
        if self.tracker is None:
            return
        self.tracker.record(wl_all, cuts=live.tree.cuts)
        if self.config.tick_every and n % self.config.tick_every == 0:
            self.tracker.tick()

    def _complete(self, tickets, sigs, found, routed, miss_index,
                  miss_epochs):
        done_at = self.clock()
        live_gens = self.service.replica_generations()
        n_cached = 0
        n_stale = 0
        latencies = []
        for t, sig, h in zip(tickets, sigs, found):
            cached = h is not None
            if cached:
                epoch, bids = h
            else:
                i = miss_index[sig]
                epoch, bids = miss_epochs[i], routed[i]
            lat = done_at - t.submitted_at
            n_cached += cached
            latencies.append(lat)
            # the audit, per replica: a response is stale iff the serving
            # replica's generation was retired BEFORE the request was
            # submitted (rollback re-liveness is not staleness — the
            # generation is serving again)
            rid = epoch.replica_id
            gat = t.gens_at_submit
            gen_at_submit = (
                gat[rid] if gat is not None and rid < len(gat)
                else t.generation_at_submit
            )
            live_gen_now = (
                live_gens[rid] if rid < len(live_gens) else live_gens[0]
            )
            if epoch.generation < gen_at_submit and (
                epoch.generation != live_gen_now
            ):
                n_stale += 1
            t._complete(ServeResult(
                bids=bids,
                generation=epoch.generation,
                desc_version=epoch.desc_version,
                cached=cached,
                latency_s=lat,
                replica_id=rid,
            ))
        with self._mutate:
            self.counters.queries_served += len(tickets)
            self.counters.queries_cached += n_cached
            self.counters.stale_responses += n_stale
        self.latency.extend(latencies)
        self.queue.release_many(tickets)

    # -- stats surface -------------------------------------------------------
    def stats(self) -> dict:
        return {
            "queue_depth": len(self.queue),
            "epoch": list(self.cache.epoch) if self.cache.epoch else None,
            "admission": self.queue.stats.as_dict(),
            "cache": self.cache.snapshot(),
            "latency": self.latency.summary(),
            "counters": self.counters.as_dict(),
        }


__all__ = ["QueryServer", "ServerCounters"]
