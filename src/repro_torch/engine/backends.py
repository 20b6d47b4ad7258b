"""Routing/intersection backends for the LayoutEngine.

Each backend registers itself under a name and implements the same
operations against a ``FrozenQdTree``:

  * ``route(tree, cache, records, device)``       — record batch → BIDs
  * ``accumulator(tree, cache, device)``          — a running fold of an
    ingest stream: ``fold(records, return_bids)`` per batch, one
    ``partial()`` (a TightenPartial) at the end; on the torch backend its
    launch geometry is the autotuner's for the tree's shape, where one is
    stored (``engine/autotune.py``), else planned by shape
  * ``fused_ingest(tree, cache, records, device)`` — BIDs + TightenPartial
    of one batch (a fresh accumulator)
  * ``query_intersect(tree, cache, wt, device, transient=False)`` —
    (n_leaves, n_queries) hits and the per-conjunct Eq. 1 scan counts;
    ``transient`` packs and uploads the workload for that call only
    (an ephemeral miss batch or ad-hoc query: no plan built, none evicted)

Two backends, bit-identical:

  * ``numpy`` — the oracles in ``repro_torch.core`` / ``kernels/ref.py``;
    its accumulator is a host ``IncrementalTightener``;
  * ``torch`` — the CUDA kernels on a GPU device, their plain PyTorch
    versions on ``cpu``; its accumulator stays on the device until
    ``partial()``.  Its packed operands come from the engine's
    :class:`~repro_torch.engine.plan.PlanCache`, built once per tree (and
    per description version, and per workload, for queries).

Records may be numpy arrays (copied to the device) or int32 tensors
already on the engine's device.  Results come back as numpy.
"""

from __future__ import annotations

# qdlint: deterministic-module

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import query as qry
from repro_torch.core.qdtree import FrozenQdTree, IncrementalTightener
from repro_torch.engine import plan as planlib
from repro_torch.engine.plan import (
    MIN_BUCKET,
    CompiledPlan,
    PlanCache,
    PlanKey,
    count_build,
    pad_bucket,
)
from repro_torch.kernels import fused_ingest as fk
from repro_torch.kernels import ops as kops
from repro_torch.kernels import query_intersect as qk
from repro_torch.kernels import route_records as rk

_REGISTRY: dict[str, "Backend"] = {}


def register_backend(name: str):
    """Class decorator: instantiate and register a backend under ``name``."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls

    return deco


def get_backend(name: str) -> "Backend":
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def as_host(records) -> np.ndarray:
    """Records as a host numpy array (a tensor is copied off its device)."""
    if isinstance(records, torch.Tensor):
        return records.cpu().numpy()
    return np.asarray(records)


class Backend:
    """Interface: route records and intersect queries for one frozen tree."""

    name: str = "?"

    def route(self, tree: FrozenQdTree, cache: PlanCache, records,
              device: torch.device) -> np.ndarray:
        raise NotImplementedError

    def accumulator(self, tree: FrozenQdTree, cache: PlanCache,
                    device: torch.device, launch=None):
        """A running route + tighten fold over any number of batches.

        ``fold(records, return_bids, on_device=False)`` routes a batch and
        folds it in (its int32 block ids if ``return_bids``, else
        ``None``; as a tensor on the engine's device if ``on_device`` and
        the backend has one, else as numpy);  ``launch`` pins the torch
        backend's kernel geometry (``IngestAccumulator``);
        ``partial()`` returns the whole stream's ``TightenPartial``,
        bit-identical to routing followed by ``IncrementalTightener.update``
        over every folded record.
        """
        raise NotImplementedError

    def fused_ingest(self, tree: FrozenQdTree, cache: PlanCache, records,
                     device: torch.device, return_bids: bool = True):
        """One single-pass route + tighten step.

        Returns ``(bids int32 (m,), TightenPartial)`` of a fresh
        accumulator that folded this batch alone.  ``return_bids=False``
        skips the per-row block-id copy to the host; the first element is
        then ``None``.
        """
        acc = self.accumulator(tree, cache, device)
        bids = acc.fold(records, return_bids)
        return bids, acc.partial()

    def query_intersect(self, tree: FrozenQdTree, cache: PlanCache,
                        wt: qry.WorkloadTensors, device: torch.device,
                        transient: bool = False):
        """``(hits (n_leaves, n_queries) bool, scanned (n_conj,) int64)``.

        ``scanned[c]`` sums the tree's block sizes (its last tightening's
        counts) over the blocks conjunct c hits.  ``transient`` keeps the
        workload's operands out of the plan cache: they serve this call
        only.
        """
        raise NotImplementedError

    def query_hits(self, tree, cache, wt, device,
                   transient: bool = False) -> np.ndarray:
        return self.query_intersect(tree, cache, wt, device, transient)[0]


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------
class HostAccumulator:
    """The numpy backend's running fold: a host ``IncrementalTightener``."""

    def __init__(self, tree: FrozenQdTree):
        self.tree = tree
        self.tightener = IncrementalTightener(tree)

    def fold(self, records, return_bids: bool = False,
             on_device: bool = False):
        rec = as_host(records)
        bids = self.tree.route(rec)
        self.tightener.update(rec, bids)
        return bids if return_bids else None

    def partial(self):
        return self.tightener.as_partial()


@register_backend("numpy")
class NumpyBackend(Backend):
    def route(self, tree, cache, records, device):
        return tree.route(as_host(records))

    def accumulator(self, tree, cache, device, launch=None):
        return HostAccumulator(tree)

    def query_intersect(self, tree, cache, wt, device, transient=False):
        conj = qry.conjuncts_intersect(
            tree.leaf_lo, tree.leaf_hi, tree.leaf_cat, tree.leaf_adv, wt,
            tree.schema,
        )
        sizes = (
            np.zeros(tree.n_leaves, np.int64)
            if tree.block_sizes is None
            else np.asarray(tree.block_sizes, np.int64)
        )
        scanned = (conj * sizes[:, None]).sum(axis=0).astype(np.int64)
        return qry.queries_intersect(conj, wt), scanned


# ---------------------------------------------------------------------------
# torch: CUDA kernels on the GPU, plain PyTorch versions on the CPU
# ---------------------------------------------------------------------------
def _on_device(records, device: torch.device) -> torch.Tensor:
    """An int32 contiguous (m, D) tensor of ``records`` on ``device``."""
    if isinstance(records, torch.Tensor):
        if records.device != device:
            raise ValueError(
                f"records are on {records.device}, the engine on {device}"
            )
        return records.to(torch.int32).contiguous()
    host = np.ascontiguousarray(records, dtype=np.int32)
    return torch.from_numpy(host).to(device)


class DeviceAccumulator:
    """The torch backend's running fold: aggregates stay on the device.

    Each ``fold`` is one ``fused_ingest`` launch (plus the block ids' copy
    when asked for them on the host); ``partial`` copies the aggregates to
    the host once.
    """

    def __init__(self, tree: FrozenQdTree, ops: dict, device: torch.device,
                 launch=None):
        self.tree = tree
        self.device = device
        self.launch = launch
        with tracing.span("ingest.accumulator"):
            self.acc = fk.IngestAccumulator(ops, launch)

    def fold(self, records, return_bids: bool = False,
             on_device: bool = False):
        bids = self.acc.fold(_on_device(records, self.device),
                             bids=return_bids)
        if not return_bids or on_device:
            return bids
        return bids.cpu().numpy()

    def partial(self):
        return self.acc.partial(self.tree)


@register_backend("torch")
class TorchBackend(Backend):
    WORKLOAD_PLANS = 16  # workloads whose operands stay on each device

    def _tree_plan(self, tree, cache, device) -> CompiledPlan:
        """Route + ingest operands: topology and cut table, and on a GPU
        ``route_descend``'s launch plan, once per tree."""
        sig = planlib.tree_signature(tree)
        node_bucket = pad_bucket(tree.n_nodes, MIN_BUCKET)
        leaf_bucket = pad_bucket(tree.n_leaves, MIN_BUCKET)
        cut_bucket = pad_bucket(tree.cuts.n_cuts, MIN_BUCKET)
        key = PlanKey(sig, "torch", 0, node_bucket, leaf_bucket, cut_bucket,
                      ("tree", str(device)))

        def build():
            count_build("tree:torch")
            ops = planlib.to_device(planlib.pack_route_constants(tree), device)
            if device.type == "cuda":
                ops["route_plan"] = rk.route_plan(ops)
            return CompiledPlan(key=key, operands=ops, meta={})

        return cache.get(key, build)

    def route(self, tree, cache, records, device):
        ops = self._tree_plan(tree, cache, device).operands
        return rk.route(_on_device(records, device), ops).cpu().numpy()

    def accumulator(self, tree, cache, device, launch=None):
        with tracing.span("ingest.plan"):
            ops = self._tree_plan(tree, cache, device).operands
        if launch is None and device.type == "cuda":
            from repro_torch.engine import autotune

            cfg = autotune.lookup("cuda", autotune.geometry_key(tree))
            launch = cfg.launch if cfg is not None else None
        return DeviceAccumulator(tree, ops, device, launch)

    def _query_plan(self, tree, cache, device) -> CompiledPlan:
        sig = planlib.tree_signature(tree)
        leaf_bucket = pad_bucket(tree.n_leaves, MIN_BUCKET)
        version = planlib.desc_version(tree)
        key = PlanKey(sig, "torch", 0, 0, leaf_bucket, 0,
                      ("query", version, str(device)))

        def build():
            count_build("query:torch")
            layout = kops.query_layout(tree.schema, tree.cuts.n_adv)
            ops = {
                "leaf": planlib.to_device(
                    planlib.pack_leaf_descs(tree, layout), device
                ),
                "layout": planlib.to_device(layout, device),
                "host_layout": layout,
            }
            # tightening superseded any older description plan: drop it so
            # long ingest/score loops keep one device copy per tree
            cache.evict(
                lambda k: (
                    isinstance(k, PlanKey)
                    and k.sig == sig
                    and k.opts[:1] == ("query",)
                    and k.opts[2:] == (str(device),)
                    and k.opts[1] != version
                )
            )
            return CompiledPlan(key=key, operands=ops, meta={})

        return cache.get(key, build)

    def _workload_plan(self, tree, wt, layout, cache,
                       device) -> CompiledPlan:
        """Conjunct operands, once per workload content, schema and cut
        table (which fix the packing), and device."""
        opts = ("workload", planlib.cuts_signature(tree.cuts), str(device))
        key = PlanKey(planlib.workload_signature(wt), "torch", 0, 0, 0, 0,
                      opts)

        def build():
            count_build("workload:torch")
            # the oldest workloads on this device make room for this one
            cache.evict(
                lambda k: isinstance(k, PlanKey) and k.opts == opts,
                keep=self.WORKLOAD_PLANS - 1,
            )
            ops = planlib.to_device(kops.pack_workload(wt, layout), device)
            return CompiledPlan(key=key, operands=ops, meta={})

        return cache.get(key, build)

    def query_intersect(self, tree, cache, wt, device, transient=False):
        ops = self._query_plan(tree, cache, device).operands
        if transient:
            # an ephemeral workload (a serving miss batch, an ad-hoc
            # query): a few KB uploaded for this launch, no plan built, no
            # standing workload's operands evicted
            conj = planlib.to_device(
                kops.pack_workload(wt, ops["host_layout"]), device
            )
        else:
            conj = self._workload_plan(tree, wt, ops["host_layout"], cache,
                                       device).operands
        hits, scanned = qk.query_intersect(ops["leaf"], conj, ops["layout"])
        conj_hits = hits.cpu().numpy().astype(bool)
        return qry.queries_intersect(conj_hits, wt), scanned.cpu().numpy()
