#!/usr/bin/env python3
"""Time ``fused_ingest``'s and ``route_descend``'s kernels on trees grown
to given leaf counts, on one GPU.

    python3 tools/fused_ingest_timings.py
        [--leaves 724 1250 1800 3000 8000 20000] [--rows N]
        [--split C R ...] [--route-only] [--route-shape W K ...]

Each tree is grown by random legal splits of a TPC-H-like sample (four
rows a leaf, seed 0) over the tpch workload's cuts
(``repro_torch.core.qdtree.random_layout``).  On a batch of ``--rows``
TPC-H-like rows (seed 5, 2**20 by default) the script folds the batch
once with each kernel and checks the block ids and aggregates against the
plain version, then prints one JSON line a tree: each kernel's launch
plan and median CUDA-event ms of 20 folds, after a warm one: the plan's
kernel, the one-thread-a-record kernel forced, the cluster kernel forced
at its own split and at each ``--split`` (blocks a cluster, ranges), or
the card's refusal of it, and the shared kernel forced where the tree
fits one block.  Its ``route`` key does the same for ``route``: the
plan's kernel, the global and prefix kernels forced (the prefix one at
the plan's warps and at 32, staging as many nodes as fill a block, and
at each ``--route-shape``: W warps a block, K nodes staged, at most the
tree's), and the shared one forced where a warp's tile fits beside the
tree, each checked against the plain
version and timed in turns (each kernel, then each again in reverse
order): ``ms`` one call between two CUDA events, median of 20, and
``stream_ms`` a call of 10 back to back (``chip_smoke.stream_ms``), the
kernel without the wrapper's host side.  ``--route-only`` skips the
folds.  Exits non-zero without a CUDA device.
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
    ap.add_argument("--route-only", action="store_true")
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
    x = torch.from_numpy(make_tpch_like(args.rows, seed=5)[1]).to(dev)
    for n_leaves in args.leaves:
        schema, sample = make_tpch_like(4 * n_leaves, seed=0)
        work, _ = make_tpch_workload(schema, n_per_template=10, seed=0)
        tree = random_layout(work.candidate_cuts(), sample, n_leaves, 0)
        ops = chip_smoke.route_ops(tree, dev)
        row = {"leaves": n_leaves, "depth": tree.depth,
               "route": route_row(rk, chip_smoke, ops, x, args.route_shape)}
        if args.route_only:
            print(json.dumps(row), flush=True)
            continue
        fits = fk.shared_warps_fit(fk.plan_shape(ops), fk.optin_bytes(
            dev.index)) >= fk.MIN_WARPS
        forced = [(None,), ("global",), ("cluster",)] + [
            ("shared",)] * fits + [("cluster", c, r) for c, r in args.split]
        plain = fk.IngestAccumulator(ops)
        want = [fk.fused_ingest_plain(x, plain), *plain.tensors()]
        for f in forced:
            try:
                with fk._forced(*f):
                    acc = fk.IngestAccumulator(ops)
            except RuntimeError as exc:  # a split the card refuses
                row[" ".join(map(str, f))] = {"refused": str(exc)}
                continue
            err = chip_smoke.max_abs_err(
                [acc.fold(x, bids=True), *acc.tensors()], want)
            row[" ".join(map(str, f))] = {
                "plan": list(acc._launch), "max_abs_err": err,
                "ms": chip_smoke.time_ms(lambda: acc.fold(x), 20)}
        print(json.dumps(row), flush=True)
    return 0


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
