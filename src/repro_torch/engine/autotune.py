"""Launch-geometry autotuner for the fused ingest kernel on the GPU.

The JAX package tunes the Pallas kernel's tiles; here the knob is the
CUDA kernel's launch geometry (``csrc/fused_ingest.cu``): which of its
designs runs (the shared-memory kernel, the cluster kernel past one
block's shared memory, whose cluster size and leaf split stay the plan's,
the leafwise design past it, whose staged nodes stay the plan's, or the
one-thread-a-record global kernel), the warps a block (the leafwise route
kernel's) and, for the shared-memory kernel, the cap on its persistent
grid.
``kernels/fused_ingest.py::layout_plan`` picks them analytically (as many
warps as fit beside the aggregates, the most blocks resident); this
module measures instead:

* :func:`autotune_fused` sweeps candidate geometries against a sample
  batch on the card.  A candidate the card cannot run is skipped with its
  reason, never clamped; every candidate that runs is held bit for bit to
  the numpy oracle (``kernels/ref.fused_ingest_ref``) before it may win,
  and timed with CUDA events.  There is no interpret mode: on an engine
  off the GPU it raises.
* :func:`lookup` / :func:`record` read/write the persisted store, keyed
  ``cuda:<geometry>`` where the geometry is the shape the plan takes
  (:func:`geometry_key`); ``TorchBackend.accumulator`` consults it when the
  caller pins no geometry.  Only ``fused_ingest`` is tuned:
  ``route_descend``'s plan stays analytic.

The store is a plain JSON file (``results/autotune_cuda.json`` by
default, override with ``REPRO_TORCH_AUTOTUNE_STORE``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Callable, Optional

import numpy as np

from repro_torch.kernels.ops import words

_ROOT = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_STORE = _ROOT / "results" / "autotune_cuda.json"
BACKEND = "cuda"

# default sweep: warps a block of the shared kernel, its grid cap in
# blocks per SM, the cluster kernel's warps a block, the leafwise route
# kernel's and the global kernel's.  A shared candidate on a tree past one
# block, or a cluster or leafwise one on a tree that fits one, is skipped
# with its reason.
SHARED_WARPS = (8, 12, 16, 20, 24, 28, 32)
SHARED_BLOCKS_PER_SM = (1, 2)
CLUSTER_WARPS = (8, 12, 16, 20, 24, 28, 32)
LEAFWISE_WARPS = (16, 21, 32)
GLOBAL_WARPS = (4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """One persisted tuning decision for a geometry."""

    variant: str  # "shared" | "cluster" | "leafwise" | "global"
    warps: int  # warps a block
    max_blocks: int  # the shared kernel's grid cap (0 for the others)
    ms: float = 0.0  # median CUDA-event ms of one fold of the sweep batch
    records_per_s: float = 0.0
    source: str = "autotune"

    @property
    def launch(self) -> tuple[str, int, int]:
        """``IngestAccumulator``'s ``launch`` argument."""
        return (self.variant, self.warps, self.max_blocks)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "LaunchConfig":
        return LaunchConfig(
            variant=str(d["variant"]),
            warps=int(d["warps"]),
            max_blocks=int(d["max_blocks"]),
            ms=float(d.get("ms", 0.0)),
            records_per_s=float(d.get("records_per_s", 0.0)),
            source=str(d.get("source", "autotune")),
        )


def geometry_key(tree) -> str:
    """The shape ``fused_ingest_plan`` takes: leaves, columns, categorical
    and advanced-cut words a leaf, categorical columns and advanced cuts
    (``kernels/fused_ingest.py::plan_shape``).  Trees of one shape share a
    plan, hence a tuned geometry."""
    schema = tree.schema
    n_adv = int(tree.cuts.n_adv)
    return (
        f"L{tree.n_leaves}-d{schema.ndims}"
        f"-cw{words(tree.cuts.in_mask.shape[1])}-aw{words(n_adv)}"
        f"-cc{int(np.count_nonzero(schema.is_categorical))}-a{n_adv}"
    )


def store_path() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_STORE")
    return pathlib.Path(env) if env else DEFAULT_STORE


def _load_store() -> dict:
    path = store_path()
    if path.exists():
        try:
            return json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            return {}
    return {}


def lookup(backend: str, geom: str) -> Optional[LaunchConfig]:
    entry = _load_store().get(f"{backend}:{geom}")
    return LaunchConfig.from_dict(entry) if entry else None


def record(backend: str, geom: str, cfg: LaunchConfig) -> None:
    store = _load_store()
    store[f"{backend}:{geom}"] = cfg.to_dict()
    path = store_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(store, indent=2, sort_keys=True) + "\n")


def _partials_identical(a, b) -> bool:
    return (
        bool(np.array_equal(a.counts, b.counts))
        and bool(np.array_equal(a.lo, b.lo))
        and bool(np.array_equal(a.hi, b.hi))
        and bool(np.array_equal(a.cat, b.cat))
        and bool(np.array_equal(a.adv, b.adv))
    )


def default_grid(sms: int) -> list[tuple[str, int, int]]:
    """The default candidates on a card of ``sms`` multiprocessors."""
    grid = [("shared", w, k * sms)
            for w in SHARED_WARPS for k in SHARED_BLOCKS_PER_SM]
    return (grid + [("cluster", w, 0) for w in CLUSTER_WARPS]
            + [("leafwise", w, 0) for w in LEAFWISE_WARPS]
            + [("global", w, 0) for w in GLOBAL_WARPS])


def cuda_event_ms(fn: Callable[[], object], reps: int) -> float:
    """Median CUDA-event ms of ``fn`` over ``reps`` calls, after one."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def autotune_fused(
    tree,
    records,
    grid=None,
    reps: int = 5,
    persist: bool = True,
    engine=None,
) -> dict:
    """Sweep ``fused_ingest``'s launch geometry on the GPU; persist the win.

    ``records`` is the sample batch (numpy, or int32 on the engine's
    device); ``grid`` a list of ``(variant, warps, grid cap)`` candidates
    (:func:`default_grid` by default).  Raises on an engine off the GPU:
    the kernels have no interpret mode, so there is nothing to tune.
    """
    from repro_torch.engine.engine import engine_for

    engine = engine if engine is not None else engine_for(tree)
    if engine.device.type != "cuda":
        raise RuntimeError(
            f"autotune_fused tunes the CUDA kernel's launch; the engine is "
            f"on {engine.device}, where the kernels have no interpret mode"
        )
    import torch

    if grid is None:
        sms = torch.cuda.get_device_properties(
            engine.device).multi_processor_count
        grid = default_grid(sms)
    return sweep(engine, records, grid, reps, persist, cuda_event_ms)


def sweep(engine, records, grid, reps: int, persist: bool,
          timer: Callable[[Callable[[], object], int], float]) -> dict:
    """:func:`autotune_fused`'s sweep on ``engine``'s device, timed by
    ``timer(fn, reps)`` (ms of one call).

    Each candidate's accumulator folds the batch once with block ids; the
    ids and the aggregates must equal the oracle's exactly, or the row is
    marked invalid and cannot win.  A candidate whose accumulator cannot
    be made (it does not fit the card) is skipped with the reason, one
    whose launch fails is marked failed with it; if none is left, the
    sweep raises rather than fall back on the analytic plan.
    """
    from repro_torch.engine import backends as be
    from repro_torch.kernels.ref import fused_ingest_ref

    tree = engine.tree
    host = be.as_host(records)
    rec = be._on_device(records, engine.device)
    oracle_bids, oracle_partial = fused_ingest_ref(tree, host)
    torch_be = be.get_backend("torch")
    geom = geometry_key(tree)
    rows = []
    for variant, warps, max_blocks in grid:
        row: dict = {"variant": variant, "warps": int(warps),
                     "max_blocks": int(max_blocks)}
        rows.append(row)
        try:
            acc = torch_be.accumulator(tree, engine.plans, engine.device,
                                       launch=(variant, warps, max_blocks))
        except ValueError as exc:
            row["status"] = "skipped"
            row["reason"] = str(exc)
            continue
        try:
            bids = acc.fold(rec, return_bids=True)
        except RuntimeError as exc:  # the launch failed: recorded, not kept
            row["status"] = "failed"
            row["reason"] = str(exc)
            continue
        row["valid"] = bool(np.array_equal(bids, oracle_bids)) and (
            _partials_identical(acc.partial(), oracle_partial))
        if not row["valid"]:
            row["status"] = "invalid"
            continue
        row["status"] = "ok"
        row["ms"] = timer(lambda: acc.fold(rec), reps)
        row["records_per_s"] = host.shape[0] / (row["ms"] / 1e3)
    valid = [r for r in rows if r["status"] == "ok"]
    if not valid:
        raise RuntimeError(
            f"autotune_fused: no candidate ran and matched the oracle: "
            f"{rows}"
        )
    best = min(valid, key=lambda r: r["ms"])
    chosen = LaunchConfig(
        variant=best["variant"], warps=best["warps"],
        max_blocks=best["max_blocks"], ms=best["ms"],
        records_per_s=best["records_per_s"],
    )
    if persist:
        record(BACKEND, geom, chosen)
    return {"geometry": geom, "rows": rows, "chosen": chosen.to_dict()}


__all__ = [
    "LaunchConfig",
    "autotune_fused",
    "default_grid",
    "geometry_key",
    "lookup",
    "record",
    "store_path",
    "sweep",
]
