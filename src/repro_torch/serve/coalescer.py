"""Request admission and micro-batch coalescing for the serving tier.

One query at a time through ``route_queries`` wastes the batching win: one
``query_intersect`` launch (on the card) or one host intersection (numpy)
amortizes its per-dispatch cost across a whole workload.  The coalescer turns
an *asynchronous* stream of individual requests back into batched
dispatches on a size-or-deadline trigger:

* :meth:`RequestQueue.submit` admits a request (bounded queue depth, a
  per-tenant in-flight bound for fairness) and returns a
  :class:`QueryTicket` the caller blocks on;
* the server's dispatcher thread pulls coalesced batches with
  :meth:`RequestQueue.next_batch`: it dispatches as soon as ``max_batch``
  requests are waiting, or when the oldest waiting request has been
  pending ``max_delay_s`` — so a lone query's latency is bounded while a
  burst rides one engine dispatch.

Admission failures raise :class:`AdmissionError` *at submit time* — load
is shed at the front door, before any routing work is queued, and the
counters distinguish queue-full from tenant-over-fair-share rejections.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Iterable, Optional

import numpy as np

from repro_torch.core import query as qry
from repro_torch.service.epoch import Epoch


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Admission + coalescing + cache policy for one :class:`QueryServer`.

    max_batch       coalesced dispatch size trigger (requests per
                    ``route_queries`` dispatch).
    max_delay_s     deadline trigger: a waiting request is dispatched at
                    most this long after it became the oldest pending one.
    max_queue       bound on queued (admitted, not yet dispatched)
                    requests; submits past it are rejected.
    max_per_tenant  per-tenant in-flight bound (queued + dispatching):
                    one greedy tenant saturating the queue cannot starve
                    admission for the others.
    cache_capacity  :class:`~repro_torch.serve.cache.ResultCache` LRU entries.
    tick_every      serving rounds (dispatches) per tracker decay
                    generation; 0 disables ticking (record-only).
    max_swap_retries  re-dispatch attempts when a hot swap lands while a
                    miss batch is routing (each retry re-captures the
                    live version and re-routes).
    """

    max_batch: int = 64
    max_delay_s: float = 0.002
    max_queue: int = 1024
    max_per_tenant: int = 256
    cache_capacity: int = 4096
    tick_every: int = 1
    max_swap_retries: int = 8

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_delay_s < 0:
            raise ValueError("max_delay_s must be >= 0")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.max_per_tenant < 1:
            raise ValueError("max_per_tenant must be >= 1")
        if self.tick_every < 0:
            raise ValueError("tick_every must be >= 0")
        if self.max_swap_retries < 0:
            raise ValueError("max_swap_retries must be >= 0")


class AdmissionError(RuntimeError):
    """A submit was rejected at the front door.

    ``reason`` is ``"queue"`` (global depth bound) or ``"tenant"``
    (per-tenant fairness bound).
    """

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass(slots=True)
class ServeResult:
    """One served query's answer, tagged with its provenance.

    ``generation``/``desc_version``/``replica_id`` identify the layout
    epoch the block IDs were computed against — the staleness audit
    trail: a response whose generation was retired *before* the request
    was submitted is a stale read, and the serving tier's contract is
    that this never happens.  Under a replica set, ``replica_id`` names
    which replica the cheapest-replica router picked.  Treat instances
    as read-only (``slots`` instead of ``frozen``: one of these is
    allocated per served query, and frozen dataclasses pay
    ``object.__setattr__`` per field on the hit path).
    """

    bids: np.ndarray  # read-only (n,) int32 block IDs
    generation: int
    desc_version: int
    cached: bool
    latency_s: float
    replica_id: int = 0

    @property
    def epoch(self) -> Epoch:
        return Epoch(self.generation, self.desc_version, self.replica_id)


# Guards only the lazy wait-event creation below — never on the
# completion fast path, so it is uncontended except when a caller
# genuinely blocks across threads.
_TICKET_EVENT_LOCK = threading.Lock()


class QueryTicket:
    """The caller's handle on one admitted request (a tiny future).

    The wait event is LAZY: the sync serving path (``serve_batch``)
    completes every ticket before anyone waits, and allocating a
    ``threading.Event`` (lock + condition) per request was the single
    biggest cost on the cache-hit path.  Completion publishes the result
    and then flips ``_finished``; a waiter that finds ``_finished`` unset
    materializes the event under :data:`_TICKET_EVENT_LOCK` and re-checks
    before blocking (Dekker-style store/load ordering — sound under the
    GIL's per-bytecode atomicity), so a completion racing the event's
    creation can never strand the waiter.
    """

    __slots__ = (
        "query", "tenant", "submitted_at", "generation_at_submit",
        "gens_at_submit",
        "_event", "_finished", "_result", "_error",
    )

    def __init__(self, query: qry.Query, tenant: str, submitted_at: float):
        self.query = query
        self.tenant = tenant
        self.submitted_at = submitted_at
        self.generation_at_submit: int = -1  # stamped by the server
        # per-replica generations live at submit time (stamped by the
        # server when a replica set is serving); None when unstamped
        self.gens_at_submit: Optional[tuple[int, ...]] = None
        self._event: Optional[threading.Event] = None
        self._finished = False
        self._result: Optional[ServeResult] = None
        self._error: Optional[BaseException] = None

    def _finish(self) -> None:
        self._finished = True  # AFTER the result/error store: flag implies
        ev = self._event       # the payload is visible
        if ev is not None:
            ev.set()

    def _complete(self, result: ServeResult) -> None:
        self._result = result
        self._finish()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._finish()

    def done(self) -> bool:
        return self._finished

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        """Block until served; raises on timeout or server-side failure."""
        if not self._finished:
            with _TICKET_EVENT_LOCK:
                ev = self._event
                if ev is None:
                    ev = self._event = threading.Event()
                if self._finished:
                    # completion raced the event's creation and may have
                    # read ``_event`` as None — don't wait on it
                    ev.set()
            if not ev.wait(timeout):
                raise TimeoutError("query not served within timeout")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


@dataclasses.dataclass
class AdmissionStats:
    accepted: int = 0
    rejected_queue: int = 0
    rejected_tenant: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class RequestQueue:
    """Bounded pending-request queue with per-tenant fairness accounting.

    In-flight (queued + currently dispatching) counts are per tenant;
    :meth:`release` returns capacity when a request completes, so the
    fairness bound tracks genuinely outstanding work, not arrival history.
    """

    def __init__(self, config: ServeConfig, clock=time.monotonic):
        self.config = config
        self.clock = clock
        self.stats = AdmissionStats()
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._pending: deque[QueryTicket] = deque()  # guarded by: self._lock
        self._inflight: dict[str, int] = {}  # guarded by: self._lock
        self._closed = False  # guarded by: self._lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)

    def inflight(self, tenant: str) -> int:
        with self._lock:
            return self._inflight.get(tenant, 0)

    def submit(self, query: qry.Query, tenant: str = "default") -> QueryTicket:
        """Admit one request or raise :class:`AdmissionError`."""
        with self._lock:
            if self._closed:
                raise RuntimeError("queue is closed")
            if len(self._pending) >= self.config.max_queue:
                self.stats.rejected_queue += 1
                raise AdmissionError(
                    "queue",
                    f"queue depth {len(self._pending)} at bound "
                    f"{self.config.max_queue}",
                )
            held = self._inflight.get(tenant, 0)
            if held >= self.config.max_per_tenant:
                self.stats.rejected_tenant += 1
                raise AdmissionError(
                    "tenant",
                    f"tenant {tenant!r} holds {held} in-flight requests "
                    f"(bound {self.config.max_per_tenant})",
                )
            ticket = QueryTicket(query, tenant, self.clock())
            self._pending.append(ticket)
            self._inflight[tenant] = held + 1
            self.stats.accepted += 1
            self._nonempty.notify()
            return ticket

    def submit_many(
        self,
        queries: Iterable[qry.Query],
        tenant: str = "default",
        *,
        enqueue: bool = True,
    ) -> list[QueryTicket]:
        """Admit a burst under ONE lock acquisition.

        Identical semantics to a :meth:`submit` loop — same per-request
        bounds, raises on the first rejection with the already-admitted
        prefix kept — minus the per-request lock traffic that would
        otherwise dominate the cache-hit serving path.

        ``enqueue=False`` admits the burst (bounds, in-flight accounting,
        admission stats) WITHOUT appending it to the pending queue: the
        caller takes responsibility for dispatching the returned tickets
        (and they must still be :meth:`release_many`-d).  This is the sync
        ``serve_batch`` path — the batch is already formed, so routing it
        through the coalescing deque would be pure overhead.
        """
        tickets: list[QueryTicket] = []
        with self._lock:
            if self._closed:
                raise RuntimeError("queue is closed")
            now = self.clock()
            cfg = self.config
            try:
                held = self._inflight.get(tenant, 0)
                depth = len(self._pending)
                for query in queries:
                    if depth >= cfg.max_queue:
                        self.stats.rejected_queue += 1
                        raise AdmissionError(
                            "queue",
                            f"queue depth {depth} at bound "
                            f"{cfg.max_queue}",
                        )
                    if held >= cfg.max_per_tenant:
                        self.stats.rejected_tenant += 1
                        raise AdmissionError(
                            "tenant",
                            f"tenant {tenant!r} holds {held} in-flight "
                            f"requests (bound {cfg.max_per_tenant})",
                        )
                    tickets.append(QueryTicket(query, tenant, now))
                    depth += 1
                    held += 1
            finally:
                if tickets:
                    if enqueue:
                        self._pending.extend(tickets)
                        self._nonempty.notify()
                    self._inflight[tenant] = held
                    self.stats.accepted += len(tickets)
        return tickets

    def release(self, ticket: QueryTicket) -> None:
        """Return the ticket's tenant slot (request left the system)."""
        with self._lock:
            held = self._inflight.get(ticket.tenant, 0)
            if held <= 1:
                self._inflight.pop(ticket.tenant, None)
            else:
                self._inflight[ticket.tenant] = held - 1

    def release_many(self, tickets: Iterable[QueryTicket]) -> None:
        """Batched :meth:`release`: one lock acquisition per dispatch."""
        with self._lock:
            for ticket in tickets:
                held = self._inflight.get(ticket.tenant, 0)
                if held <= 1:
                    self._inflight.pop(ticket.tenant, None)
                else:
                    self._inflight[ticket.tenant] = held - 1

    def next_batch(
        self, timeout: Optional[float] = None
    ) -> list[QueryTicket]:
        """Block for the next coalesced batch (size-or-deadline trigger).

        Returns up to ``max_batch`` tickets: immediately once
        ``max_batch`` are pending, otherwise when the oldest pending
        ticket has waited ``max_delay_s``.  An empty list means the
        ``timeout`` expired (or the queue closed) with nothing pending.
        """
        cfg = self.config
        deadline = None if timeout is None else self.clock() + timeout
        with self._lock:
            while not self._pending:
                if self._closed:
                    return []
                wait = (
                    None if deadline is None else deadline - self.clock()
                )
                if wait is not None and wait <= 0:
                    return []
                self._nonempty.wait(wait)
            # coalesce: hold the door open until the batch fills or the
            # oldest waiter's deadline arrives
            dispatch_at = self._pending[0].submitted_at + cfg.max_delay_s
            while (
                len(self._pending) < cfg.max_batch and not self._closed
            ):
                wait = dispatch_at - self.clock()
                if wait <= 0:
                    break
                self._nonempty.wait(wait)
            batch = []
            while self._pending and len(batch) < cfg.max_batch:
                batch.append(self._pending.popleft())
            return batch

    def close(self) -> list[QueryTicket]:
        """Stop admitting; drain and return whatever was still pending."""
        with self._lock:
            self._closed = True
            drained = list(self._pending)
            self._pending.clear()
            self._nonempty.notify_all()
            return drained


__all__ = [
    "AdmissionError",
    "AdmissionStats",
    "QueryTicket",
    "RequestQueue",
    "ServeConfig",
    "ServeResult",
]
