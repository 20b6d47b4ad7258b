"""LayoutEngine subsystem: one backend-dispatched routing/query API.

Public surface:
  LayoutEngine   — route / fused_step / ingest / query_hits /
                   route_queries / skip_stats over a frozen tree
  WindowStat / ObservationProbe — Eq. 1 per-batch skip-rate accounting
  engine_for     — the per-tree attached engine (shared plan cache)
  register_backend / get_backend / available_backends — backend registry
  PlanCache / pad_bucket / build_counts — plan cache + plan-build counters
  ShardIngestor / ShardState / MergeCoordinator / sharded_ingest —
                   parallel shard routing with associative merge
  LaunchConfig / autotune_fused / geometry_key — the fused-ingest
                   kernel's launch-geometry autotuner
"""

from repro_torch.engine.autotune import (  # noqa: F401
    LaunchConfig,
    autotune_fused,
    geometry_key,
)

from repro_torch.engine.backends import (  # noqa: F401
    Backend,
    available_backends,
    get_backend,
    register_backend,
)
from repro_torch.engine.engine import (  # noqa: F401
    IngestReport,
    LayoutEngine,
    ObservationProbe,
    WindowStat,
    WorkloadTensorCache,
    engine_for,
)
from repro_torch.engine.plan import (  # noqa: F401
    CompiledPlan,
    PlanCache,
    PlanKey,
    build_counts,
    cuts_signature,
    pad_bucket,
    resolve_device,
)
from repro_torch.engine.sharded import (  # noqa: F401
    MergeCoordinator,
    ShardedIngestReport,
    ShardIngestor,
    ShardState,
    process_pool,
    replicate_tree,
    shard_slices,
    sharded_ingest,
    shutdown_process_pool,
)
