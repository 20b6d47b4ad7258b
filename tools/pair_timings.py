#!/usr/bin/env python3
"""Time the port's kernels and main-path calls of two checkouts on one
GPU, in turns.

    python3 tools/pair_timings.py PARENT_ROOT CHANGE_ROOT [--rounds N]

Each root is a checkout of the repository (its ``src/repro_torch``).  The
script runs one process a side, parent, change, change, parent, ... for
``--rounds`` pairs, so that two versions meet on the same card in one
call.  Each process builds its own kernels (into its checkout's
``build/kernels``), makes a 2**20-row TPC-H-like batch (seed 0) and a
greedy layout learned from 1 in 200 of its rows at ``min_block=4`` (the
layout is saved once and shared), and prints one JSON line: the median
CUDA-event ms of 30 wrapper calls of route (``route_descend``), one fold of
``fused_ingest``, ``eval_cuts`` at 400,000 and 2**20 rows, and
``locate_leaf`` at 2**20 rows; and the median host-clock ms of warm
``LayoutEngine`` calls: ``route`` of the batch (ids on the host),
``route_queries`` of the 150-query workload and ``route_query`` of its
first query (30 each), and the ``ingest`` of the batch 8 times over into
a fresh engine (5).  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

SIDE = r'''
import json, os, sys, time
root, tree_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.join(root, "src"))
import numpy as np, torch
from repro_torch.core.qdtree import FrozenQdTree
from repro_torch.data.datagen import make_tpch_like
from repro_torch.data.workload import make_tpch_workload
from repro_torch.engine import LayoutEngine
from repro_torch.engine import plan as tplan
from repro_torch.kernels import _build, fused_ingest as fk, route_records as rk
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
dev = torch.device("cuda", 0)
_build.build_all()
schema, records = make_tpch_like(1 << 20, seed=0)
work, _ = make_tpch_workload(schema, n_per_template=10, seed=0)
if not os.path.exists(tree_path):
    from repro_torch.core.greedy import GreedyConfig, build_greedy
    tree = build_greedy(records[::200], work, work.candidate_cuts(),
                        GreedyConfig(min_block=4)).freeze()
    np.savez(tree_path, **tree.to_arrays())
tree = FrozenQdTree.from_arrays(dict(np.load(tree_path, allow_pickle=True)))
ops = tplan.to_device(tplan.pack_route_constants(tree), dev)
x = torch.from_numpy(records).to(dev)


def time_ms(fn, reps=30):
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def host_ms(fn, reps=30):
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def ingest_ms():
    eng = LayoutEngine(FrozenQdTree.from_arrays(arrays))
    eng.warm_ingest({x.shape[0]})
    torch.cuda.synchronize()
    return eng.ingest([x] * 8).wall_s * 1e3


arrays = tree.to_arrays()
engine = LayoutEngine(FrozenQdTree.from_arrays(arrays))
acc = fk.IngestAccumulator(ops)
mat = rk.eval_cuts(x, ops)
out = {  # the engine's calls first, before the kernels' timing loops
    "engine_route_host": host_ms(lambda: engine.route(x)),
    "engine_route_queries_host": host_ms(lambda: engine.route_queries(work)),
    "engine_route_query_host": host_ms(
        lambda: engine.route_query(work.queries[0])),
    "engine_ingest_8_batches_host": float(np.median(
        [ingest_ms() for _ in range(5)])),
    "route_descend": time_ms(lambda: rk.route(x, ops)),
    "fused_ingest_shared": time_ms(lambda: acc.fold(x)),
    "eval_cuts_400000": time_ms(lambda: rk.eval_cuts(x[:400_000], ops)),
    "eval_cuts_1048576": time_ms(lambda: rk.eval_cuts(x, ops)),
    "locate_leaf_1048576": time_ms(lambda: rk.locate_leaf(mat, ops)),
}
if not torch.equal(rk.locate_leaf(mat, ops), rk.route(x, ops)):
    sys.exit("locate_leaf differs from route")
print(json.dumps({"root": root, **out}))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        tree_path = os.path.join(tmp, "tree.npz")
        for i in range(args.rounds):
            sides = (args.parent, args.change)
            for root in sides if i % 2 == 0 else sides[::-1]:
                res = subprocess.run(
                    [sys.executable, "-c", SIDE, root, tree_path],
                    capture_output=True, text=True,
                    env={**os.environ, "PYTHONPATH": ""},
                )
                if res.returncode != 0:
                    print(res.stderr[-2000:], file=sys.stderr)
                    return res.returncode
                print(res.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
