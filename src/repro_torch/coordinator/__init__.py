"""Fleet coordination: fold worker partials, drive the layout epoch."""

from repro_torch.coordinator.fleet import FleetCoordinator, FoldReport, WorkerHandle

__all__ = ["FleetCoordinator", "FoldReport", "WorkerHandle"]
