"""The serving tier: async front end + semantic result cache.

Layers (each its own module, composed by :class:`QueryServer`):

* ``coalescer`` — request admission (bounded queue depth, per-tenant
  fairness) and micro-batch coalescing on a size-or-deadline trigger, so
  the batched-routing win reaches individual async callers;
* ``cache`` — the semantic result cache: routed block-ID lists keyed by
  ``(epoch, exact canonical predicate signature)``, invalidated by the
  serving epoch (generation hot swaps AND in-place tighten bumps);
* ``server`` — the dispatch core tying them to a
  :class:`~repro_torch.service.service.LayoutService`, with the staleness
  audit and workload-tracker observation;
* ``stats`` — latency percentiles for the benchmark surface.
"""

from repro_torch.serve.cache import (
    EXACT_RESOLUTION,
    CacheStats,
    Epoch,
    ResultCache,
    exact_signatures,
)
from repro_torch.serve.coalescer import (
    AdmissionError,
    AdmissionStats,
    QueryTicket,
    RequestQueue,
    ServeConfig,
    ServeResult,
)
from repro_torch.serve.server import QueryServer, ServerCounters
from repro_torch.serve.stats import LatencyRecorder

__all__ = [
    "EXACT_RESOLUTION",
    "AdmissionError",
    "AdmissionStats",
    "CacheStats",
    "Epoch",
    "LatencyRecorder",
    "QueryServer",
    "QueryTicket",
    "RequestQueue",
    "ResultCache",
    "ServeConfig",
    "ServeResult",
    "ServerCounters",
    "exact_signatures",
]
