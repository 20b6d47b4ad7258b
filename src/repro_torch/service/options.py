"""Typed option surfaces for the LayoutService facade.

``LayoutService.ingest`` and ``LayoutService.auto_rebuilder`` each take
one dataclass instead of a spread of keyword arguments, so ONE entry
point ingests everything:

    svc.ingest(batches)                                   # streaming
    svc.ingest(records, IngestOptions(shards=4))          # sharded
    svc.auto_rebuilder(RebuildPolicy(workload="auto", tracker=t))
"""

from __future__ import annotations

import dataclasses
from typing import Optional

#: ``IngestOptions.batch`` when it is None: the engine's batch on the
#: card (one ``fused_ingest`` launch and, when observed, one 8-byte sum
#: copied back per 2^20 rows), the reference's on the CPU
CUDA_BATCH = 1 << 20
CPU_BATCH = 2048


@dataclasses.dataclass(frozen=True)
class IngestOptions:
    """How one ingest run observes, monitors, and parallelizes.

    observe      Workload | WorkloadTensors | ObservationProbe — Eq. 1
                 per-batch skip accounting against a standing workload.
    monitor      an :class:`~repro_torch.service.drift.AutoRebuilder`: batches
                 tee into its reservoir and observations drive its drift
                 policy (may fire a background rebuild mid-stream).
    fused        single-pass route+tighten kernels (default) vs the
                 two-pass route-then-tighten path.
    executor     sharded runs: ``None`` picks CUDA streams of one context
                 (``"thread"``) on the card and resident spawn workers
                 (``"process"``) on the CPU for ``shards >= 2``;
                 ``"thread"`` on the CPU carries a PerformanceWarning
                 (GIL-bound); any ``concurrent.futures`` Executor
                 instance is used as-is.
    shards       None/1 streams single-stream; k >= 2 splits the record
                 array across k ShardIngestors and folds their states
                 associatively (requires a record array, not a batch
                 iterable).
    batch        micro-batch rows when ``ingest`` is handed a record
                 array (sharded or not); None takes :data:`CUDA_BATCH`
                 on the card and :data:`CPU_BATCH` on the CPU.
    """

    observe: object = None
    monitor: object = None
    fused: bool = True
    executor: object = None
    shards: Optional[int] = None
    batch: Optional[int] = None

    def __post_init__(self):
        if self.shards is not None and self.shards < 1:
            raise ValueError("shards must be >= 1")
        if self.batch is not None and self.batch < 1:
            raise ValueError("batch must be >= 1")


@dataclasses.dataclass(frozen=True)
class RebuildPolicy:
    """When and how the service rebuilds itself.

    workload     a declared standing Workload, or ``"auto"`` to score
                 drift (and rebuild) against the tracker-inferred live
                 mix.
    tracker      the WorkloadTracker the serving path records into
                 (``workload="auto"``; omitted, one is created).
    drift        :class:`~repro_torch.service.drift.DriftConfig` trigger
                 policy (threshold + hysteresis + cooldown).
    replicas     k > 1 makes triggered rebuilds deploy a k-replica
                 set via :meth:`LayoutService.rebuild_replicas`
                 (cheapest-replica routing); 1 keeps today's
                 single-tree rebuild.
    lam          uniform-prior blend weight for replica clustering
                 (see ``repro_torch.service.replica``).
    reservoir_capacity  recent-record reservoir size for rebuilds.
    executor     ``None`` (private worker thread), ``"sync"``
                 (rebuild inline — deterministic tests/benchmarks),
                 or any Executor.
    rebuild_kw   extra kwargs forwarded to ``service.rebuild`` /
                 ``service.rebuild_replicas`` (e.g. ``swap=``,
                 ``strategy=``, ``min_block=``).
    """

    workload: object = "auto"
    tracker: object = None
    drift: object = None  # DriftConfig | None
    replicas: int = 1
    lam: float = 0.25
    reservoir_capacity: int = 65536
    executor: object = None
    rebuild_kw: Optional[dict] = None

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if not 0.0 <= self.lam <= 1.0:
            raise ValueError("lam must be in [0, 1]")


__all__ = ["CPU_BATCH", "CUDA_BATCH", "IngestOptions", "RebuildPolicy"]
