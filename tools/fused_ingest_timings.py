#!/usr/bin/env python3
"""Time ``fused_ingest``'s and ``route_descend``'s kernels on trees grown
to given leaf counts, on one GPU.

    python3 tools/fused_ingest_timings.py
        [--leaves 724 1250 1800 3000 8000 20000] [--rows N]
        [--split C R ...] [--leafwise W ...] [--route-only | --fold-only]
        [--route-shape W K ...] [--table N] [--stages]

Each tree is grown by random legal splits of a TPC-H-like sample (four
rows a leaf, seed 0) over the tpch workload's cuts
(``repro_torch.core.qdtree.random_layout``), or, with ``--table N``, of
the 1% sample of an N-row TPC-H-like table (seed 0), as ``chip_smoke.py``
grows its trees (40,000,000 for its table: shallower trees, on which the
first draft runs faster).  On a batch of ``--rows`` TPC-H-like rows
(seed 5, 2**20 by default; with ``--table``, the table's first rows) the
script folds the batch
once with each design and checks the block ids and aggregates against
the plain version, then prints one JSON line a tree: each design's launch
plan, ``ms`` (one fold between two CUDA events, median of 20, after a
warm one) and ``stream_ms`` (a fold's device time, 10 back to back),
timed in turns (each design, then each again in reverse order): the
plan's design, the leafwise design forced (its plan, and W warps a route
block at each ``--leafwise``), the
one-thread-a-record kernel forced, the cluster kernel forced at its own
split and at each ``--split`` (blocks a cluster, ranges), or the card's
refusal of it, and the shared kernel forced where the tree fits one
block.  Its ``route`` key does the same for ``route``: the
plan's kernel, the global and prefix kernels forced (the prefix one at
the plan's warps and at 32, staging as many nodes as fill a block, and
at each ``--route-shape``: W warps a block, K nodes staged, at most the
tree's), and the shared one forced where a warp's tile fits beside the
tree, each checked against the plain
version and timed in turns (each kernel, then each again in reverse
order): ``ms`` one call between two CUDA events, median of 20, and
``stream_ms`` a call of 10 back to back (``chip_smoke.stream_ms``), the
kernel without the wrapper's host side.  ``--route-only`` skips the
folds, ``--fold-only`` the routes; ``--stages`` adds each leafwise
kernel's device ms (median of a trace of 10 folds, by
``chip_smoke.traced_kernels``).  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leaves", type=int, nargs="+",
                    default=[724, 1250, 1800, 3000, 8000, 20000])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--split", type=int, nargs=2, action="append",
                    default=[], metavar=("C", "R"))
    ap.add_argument("--leafwise", type=int, action="append", default=[],
                    metavar="W")
    ap.add_argument("--route-only", action="store_true")
    ap.add_argument("--fold-only", action="store_true")
    ap.add_argument("--table", type=int, default=0)
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--route-shape", type=int, nargs=2, action="append",
                    default=[], metavar=("W", "K"))
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("fused_ingest_timings: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.core.qdtree import random_layout
    from repro_torch.data.datagen import make_tpch_like
    from repro_torch.data.workload import make_tpch_workload
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_ingest as fk
    from repro_torch.kernels import route_records as rk

    dev = torch.device("cuda", torch.cuda.current_device())
    _build.build_all()
    if args.table:
        schema, table = make_tpch_like(args.table, seed=0)
        table_sample = table[::chip_smoke.SAMPLE_EVERY]
        x = torch.from_numpy(table[:args.rows].copy()).to(dev)
        del table
    else:
        x = torch.from_numpy(make_tpch_like(args.rows, seed=5)[1]).to(dev)
    for n_leaves in args.leaves:
        if args.table:
            sample = table_sample
        else:
            schema, sample = make_tpch_like(4 * n_leaves, seed=0)
        work, _ = make_tpch_workload(schema, n_per_template=10, seed=0)
        tree = random_layout(work.candidate_cuts(), sample, n_leaves, 0)
        ops = chip_smoke.route_ops(tree, dev)
        row = {"leaves": n_leaves, "depth": tree.depth}
        if not args.fold_only:
            row["route"] = route_row(rk, chip_smoke, ops, x, args.route_shape)
        if not args.route_only:
            row.update(fold_row(fk, chip_smoke, ops, x, args.split,
                                args.leafwise, args.stages))
        print(json.dumps(row), flush=True)
    return 0


def fold_row(fk, chip_smoke, ops, x, splits, leafwise, stages) -> dict:
    """Each design's plan, error against the plain version and ms (in
    turns) on the batch ``x``, forced as the module docstring lists; a
    design the card or the plan refuses is recorded with the reason; with
    ``stages``, the forced leafwise design's kernels' device ms."""
    fits = fk.shared_warps_fit(fk.plan_shape(ops), fk.optin_bytes(
        x.device.index)) >= fk.MIN_WARPS
    forced = ([(None,), ("leafwise",), ("global",), ("cluster",)]
              + [("shared",)] * fits + [("cluster", c, r) for c, r in splits]
              + [("leafwise", None, None, w) for w in leafwise])
    plain = fk.IngestAccumulator(ops)
    want = [fk.fused_ingest_plain(x, plain), *plain.tensors()]
    out, runs = {}, {}
    for f in forced:
        key = " ".join(map(str, f))
        try:
            with fk._forced(*f):
                acc = fk.IngestAccumulator(ops)
        except (RuntimeError, ValueError) as exc:  # refused
            out[key] = {"refused": str(exc)}
            continue
        out[key] = {"plan": list(acc._launch), "ms": [], "stream_ms": [],
                    "max_abs_err": chip_smoke.max_abs_err(
                        [acc.fold(x, bids=True), *acc.tensors()], want)}
        runs[key] = (lambda a=acc: a.fold(x))
    for key in [*runs, *reversed(runs)]:
        out[key]["ms"].append(chip_smoke.time_ms(runs[key], 20))
        out[key]["stream_ms"].append(chip_smoke.stream_ms(runs[key]))
    if stages and "leafwise" in runs:
        spans = chip_smoke.traced_kernels(runs["leafwise"], 10)
        out["leafwise"]["stages_ms"] = {
            k: float(np.median(v)) for k, v in spans.items()}
    return out


def route_row(rk, chip_smoke, ops, x, shapes) -> dict:
    """Each route kernel's plan, error against the plain version and ms
    (in turns) on the batch ``x``; the prefix kernel also at each (warps,
    staged nodes) of ``shapes``."""
    want = rk.route_plain(x, ops)
    n_nodes = int(ops["nodes"].shape[0])
    forced = [(None,), ("global",), ("prefix",), ("prefix", 32)] + [
        ("prefix", w, min(k, n_nodes)) for w, k in shapes]
    if rk.shared_fit(n_nodes, x.shape[1],
                     rk.optin_bytes(x.device.index)) >= 1:
        forced.append(("shared",))
    out, runs = {}, {}
    for f in forced:
        with rk._forced(*f):
            plan = rk.route_plan(ops)
        o = {**ops, "route_plan": plan}
        key = " ".join(map(str, f))
        out[key] = {"plan": list(plan), "ms": [], "stream_ms": [],
                    "max_abs_err": chip_smoke.max_abs_err([rk.route(x, o)],
                                                          [want])}
        runs[key] = (lambda o=o: rk.route(x, o))
    for key in [*runs, *reversed(runs)]:
        out[key]["ms"].append(chip_smoke.time_ms(runs[key], 20))
        out[key]["stream_ms"].append(chip_smoke.stream_ms(runs[key]))
    return out


if __name__ == "__main__":
    sys.exit(main())
