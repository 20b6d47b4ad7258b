"""LayoutService subsystem: one lifecycle API over qd-tree layouts.

Public surface:
  build_layout / LayoutBuild            — strategy-dispatched construction
  register_builder / get_builder / available_strategies — builder registry
  LayoutService                          — versioned serving facade with
                                           rebuild-in-place hot swap
  LayoutVersion / RebuildReport          — lifecycle artifacts
  DriftMonitor / DriftConfig / AutoRebuilder / RecordReservoir —
                                           drift-triggered auto-rebuild
  WorkloadTracker / TrackerConfig / TrackerState —
                                           workload auto-detection from the
                                           serving path (inferred live mix)
  Epoch                                  — the (generation, desc_version,
                                           replica_id) serving identity
  IngestOptions / RebuildPolicy          — typed option dataclasses for the
                                           ingest / auto-rebuild surfaces
  ReplicaSet / ReplicaRoute / ReplicaRebuildReport —
                                           k-replica layouts with
                                           cheapest-replica routing
"""

from repro_torch.service.builders import (  # noqa: F401
    LayoutBuild,
    LayoutBuilder,
    available_strategies,
    build_layout,
    get_builder,
    register_builder,
)
from repro_torch.service.drift import (  # noqa: F401
    AutoRebuilder,
    DriftConfig,
    DriftDecision,
    DriftMonitor,
    RebuildEvent,
    RecordReservoir,
)
from repro_torch.service.epoch import Epoch  # noqa: F401
from repro_torch.service.options import (  # noqa: F401
    IngestOptions,
    RebuildPolicy,
)
from repro_torch.service.replica import (  # noqa: F401
    ReplicaRebuildReport,
    ReplicaRoute,
    ReplicaSet,
    cluster_signatures,
    cluster_workloads,
    workload_signature_weights,
)
from repro_torch.service.service import (  # noqa: F401
    LayoutService,
    LayoutVersion,
    RebuildReport,
)
from repro_torch.service.tracker import (  # noqa: F401
    TrackerConfig,
    TrackerState,
    WorkloadTracker,
    merge_states,
    query_signatures,
    query_signatures_from_tensors,
)
