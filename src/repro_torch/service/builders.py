"""Layout builder registry: one construction API over every strategy.

The paper describes several ways to arrive at a layout — greedy Algorithm 1,
the WOODBLOCK RL agent (Sec 5.2), the bottom-up baseline, and the trivial
random/range partitioners (Sec 7.3) — and the repo used to expose each as a
differently-shaped entry point.  Here they all implement one
:class:`LayoutBuilder` protocol and register under a strategy name, so

    build = build_layout(records, workload, strategy="greedy", min_block=600)

returns the same :class:`LayoutBuild` artifact regardless of strategy: a
tightened ``FrozenQdTree``, the build records' BIDs, Eq. 1 build metrics,
and provenance (config + input sizes) for reproducibility.

A build runs on a device (the GPU unless ``device="cpu"``): the qd-tree
strategies route and tighten the build records through a
:class:`~repro_torch.engine.LayoutEngine` there (one ``fused_ingest``),
and every strategy's Eq. 1 block-hit matrix comes from that engine's
``query_hits`` — array-equal to the host numpy hits.  The tree search
itself (greedy, the baselines, WOODBLOCK's episodes) is host numpy;
WOODBLOCK's network trains on the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core import greedy as greedy_mod
from repro_torch.core import query as qry
from repro_torch.core.predicates import CutTable
from repro_torch.core.qdtree import FrozenQdTree, IncrementalTightener
from repro_torch.engine import LayoutEngine, PlanCache
from repro_torch.engine import plan as planlib

_REGISTRY: dict[str, "LayoutBuilder"] = {}


def register_builder(name: str):
    """Class decorator: instantiate and register a builder under ``name``."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls()
        return cls

    return deco


def get_builder(name: str) -> "LayoutBuilder":
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; available: {available_strategies()}"
        ) from None


def available_strategies() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@dataclasses.dataclass
class LayoutBuild:
    """The common construction artifact every strategy returns.

    ``tree`` is frozen and min-max tightened on ``records``; ``bids`` is the
    layout's block assignment of those records (for qd-tree strategies this
    is ``tree.route(records)``, for baselines the directly-assigned BIDs).
    """

    tree: FrozenQdTree
    bids: np.ndarray
    strategy: str
    build_s: float
    metrics: dict  # scanned_fraction (Eq. 1 on build inputs) + extras
    provenance: dict  # config, input sizes, seed — enough to rebuild

    @property
    def n_leaves(self) -> int:
        return self.tree.n_leaves

    @property
    def scanned_fraction(self) -> float:
        return float(self.metrics["scanned_fraction"])


class LayoutBuilder:
    """Interface: construct one layout from (records, workload, cuts).

    Implementations return ``(frozen_tightened_tree, bids, extra_metrics)``;
    :func:`build_layout` wraps that with timing, Eq. 1 scoring, and
    provenance into a :class:`LayoutBuild`.  ``device`` and ``plan_cache``
    place the build's engines (:func:`_route_and_tighten`).
    """

    name: str = "?"

    def build(
        self,
        records: np.ndarray,
        workload: qry.Workload,
        cuts: CutTable,
        min_block: int,
        seed: int = 0,
        device=None,
        plan_cache: Optional[PlanCache] = None,
        **cfg,
    ) -> tuple[FrozenQdTree, np.ndarray, dict]:
        raise NotImplementedError


def _route_and_tighten(tree: FrozenQdTree, records: np.ndarray, device,
                       plan_cache: Optional[PlanCache]) -> np.ndarray:
    """Route ``records`` through ``tree`` and min-max-tighten it on them in
    one pass of an engine on ``device``: bit-identical to ``tree.route``
    followed by ``tree.tighten``."""
    eng = LayoutEngine(tree, device=device, plan_cache=plan_cache)
    bids, part = eng.fused_step(records)
    t = IncrementalTightener(tree)
    t.merge(part)
    t.apply()
    return bids


@register_builder("greedy")
class GreedyBuilder(LayoutBuilder):
    """Paper Algorithm 1 (core/greedy.py)."""

    def build(self, records, workload, cuts, min_block, seed=0,
              device=None, plan_cache=None, **cfg):
        gcfg = greedy_mod.GreedyConfig(
            min_block=min_block,
            max_leaves=cfg.pop("max_leaves", None),
            allow_small_child=cfg.pop("allow_small_child", False),
        )
        _reject_unknown(self, cfg)
        tree = greedy_mod.build_greedy(records, workload, cuts, gcfg)
        frozen = tree.freeze()
        bids = _route_and_tighten(frozen, records, device, plan_cache)
        return frozen, bids, {"depth": int(frozen.depth)}


@register_builder("woodblock")
class WoodblockBuilder(LayoutBuilder):
    """WOODBLOCK deep-RL agent (paper Sec 5.2); deploys the best episode."""

    def build(self, records, workload, cuts, min_block, seed=0,
              device=None, plan_cache=None, **cfg):
        from repro_torch.core.woodblock.agent import (
            WoodblockConfig,
            build_woodblock,
        )

        wcfg = WoodblockConfig(
            min_block_sample=min_block,
            n_iters=cfg.pop("n_iters", 20),
            episodes_per_iter=cfg.pop("episodes_per_iter", 4),
            time_budget_s=cfg.pop("time_budget_s", None),
            seed=seed,
            max_leaves=cfg.pop("max_leaves", None),
            allow_small_child=cfg.pop("allow_small_child", False),
        )
        _reject_unknown(self, cfg)
        res = build_woodblock(records, workload, cuts, wcfg, device=device)
        frozen = res.best_tree.freeze()
        bids = _route_and_tighten(frozen, records, device, plan_cache)
        return frozen, bids, {
            "best_scanned_sample": float(res.best_scanned),
            "n_episodes": int(res.n_episodes),
            "curve": res.curve,
        }


@register_builder("bottom_up")
class BottomUpBuilder(LayoutBuilder):
    """Bottom-up baseline (paper Sec 7.3; BU+ via selectivity_ceiling)."""

    def build(self, records, workload, cuts, min_block, seed=0,
              device=None, plan_cache=None, **cfg):
        from repro_torch.baselines import bottom_up

        bcfg = bottom_up.BottomUpConfig(
            block_size=min_block,
            max_features=cfg.pop("max_features", 15),
            selectivity_ceiling=cfg.pop("selectivity_ceiling", None),
            frequency_floor=cfg.pop("frequency_floor", 1),
        )
        _reject_unknown(self, cfg)
        tree, bids = bottom_up.build_bottom_up(records, workload, cuts, bcfg)
        return tree, bids, {}


@register_builder("random")
class RandomBuilder(LayoutBuilder):
    """Random shuffler into fixed-size blocks (TPC-H baseline, Sec 7.3)."""

    def build(self, records, workload, cuts, min_block, seed=0,
              device=None, plan_cache=None, **cfg):
        from repro_torch.baselines import partitioners

        _reject_unknown(self, cfg)
        tree, bids = partitioners.random_layout(
            records, workload.schema, cuts, min_block, seed=seed
        )
        return tree, bids, {}


@register_builder("range")
class RangeBuilder(LayoutBuilder):
    """Range partitioning on one column (ErrorLog default scheme)."""

    def build(self, records, workload, cuts, min_block, seed=0,
              device=None, plan_cache=None, **cfg):
        from repro_torch.baselines import partitioners

        column = cfg.pop("column", 0)
        _reject_unknown(self, cfg)
        tree, bids = partitioners.range_layout(
            records, workload.schema, cuts, min_block, column=column
        )
        return tree, bids, {}


def _reject_unknown(builder: LayoutBuilder, cfg: dict) -> None:
    if cfg:
        raise TypeError(
            f"strategy {builder.name!r} got unknown config keys "
            f"{sorted(cfg)}"
        )


def build_layout(
    records: np.ndarray,
    workload: qry.Workload,
    strategy: str = "greedy",
    cuts: Optional[CutTable] = None,
    min_block: Optional[int] = None,
    seed: int = 0,
    device=None,
    plan_cache: Optional[PlanCache] = None,
    **cfg,
) -> LayoutBuild:
    """Construct a layout with any registered strategy → :class:`LayoutBuild`.

    ``cuts`` defaults to the workload's candidate cuts (paper Sec 3.4);
    ``min_block`` defaults to ``max(len(records) // 64, 1)``.  Remaining
    keyword arguments are strategy-specific (e.g. ``n_iters`` for
    ``woodblock``, ``column`` for ``range``).  The build's engines run on
    ``device`` (None: the GPU) and keep their plans in ``plan_cache`` (a
    service passes its own, so a deployed build starts warm).
    """
    builder = get_builder(strategy)
    device = planlib.resolve_device(device)
    if plan_cache is None:
        plan_cache = PlanCache()
    if cuts is None:
        cuts = workload.candidate_cuts(max_adv=cfg.pop("max_adv", 8))
    if min_block is None:
        min_block = max(records.shape[0] // 64, 1)
    t0 = time.perf_counter()
    tree, bids, extra = builder.build(
        records, workload, cuts, min_block=min_block, seed=seed,
        device=device, plan_cache=plan_cache, **cfg
    )
    build_s = time.perf_counter() - t0

    bids = np.asarray(bids, np.int32)
    sizes = np.bincount(bids, minlength=tree.n_leaves).astype(np.int64)
    hits = LayoutEngine(
        tree, device=device, plan_cache=plan_cache
    ).query_hits(workload.tensorize(tree.cuts))
    denom = records.shape[0] * len(workload)
    scanned = float((hits * sizes[:, None]).sum() / denom) if denom else 0.0
    metrics = {
        "scanned_fraction": scanned,
        "n_leaves": int(tree.n_leaves),
        **extra,
    }
    provenance = {
        "strategy": strategy,
        "min_block": int(min_block),
        "seed": int(seed),
        "n_records": int(records.shape[0]),
        "n_queries": len(workload),
        "n_cuts": int(cuts.n_cuts),
        "config": {k: _jsonable(v) for k, v in cfg.items()},
    }
    return LayoutBuild(
        tree=tree,
        bids=bids,
        strategy=strategy,
        build_s=build_s,
        metrics=metrics,
        provenance=provenance,
    )


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v
