"""LayoutEngine subsystem: one backend-dispatched routing/query API.

Public surface:
  LayoutEngine   — route / fused_step / ingest / query_hits /
                   route_queries / skip_stats over a frozen tree
  WindowStat / ObservationProbe — Eq. 1 per-batch skip-rate accounting
  engine_for     — the per-tree attached engine (shared plan cache)
  register_backend / get_backend / available_backends — backend registry
  PlanCache / pad_bucket / build_counts — plan cache + plan-build counters
"""

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
