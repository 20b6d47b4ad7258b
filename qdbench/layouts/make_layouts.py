"""Learn each configuration's qd-tree once, offline, on the CPU.

    PYTHONPATH=src python qdbench/layouts/make_layouts.py tpch-sf100-b600k

A layout is the cell's data, as weights are a model's: a qd-tree learned
once from a sample and then deployed.  This script draws the sample from
the benchmark's own generator (``qdbench/datagen.py``, on the CPU, from
the configuration's ``layout.sample_seed``), takes the 150 queries of
``make_tpch_workload(schema, n_per_template=10, seed=0)`` and their
candidate cuts, runs the program's greedy builder (paper Algorithm 1)
with the configuration's ``layout.min_block``, and writes
``qdbench/layouts/<config>.npz`` (``FrozenQdTree.to_arrays()``) and, into
the configuration's file, the leaf count, depth, nodes, build seconds and
the arrays' sha256 (``qdbench/layout.py::digest``).

No run of the benchmark executes this script: a run loads the file and
checks its digest, so a later change to the builder cannot move the
yardstick.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
sys.path.insert(0, str(BENCH.parent))
sys.path.insert(0, str(BENCH.parent / "src"))

from qdbench import datagen, layout  # noqa: E402


def build(config: str) -> dict:
    from repro_torch.core import predicates as preds
    from repro_torch.core.greedy import GreedyConfig, build_greedy
    from repro_torch.data.workload import make_tpch_workload

    path = BENCH / "configs" / f"{config}.json"
    cfg = json.loads(path.read_text())
    spec = cfg["layout"]
    schema = preds.Schema(tuple(preds.Column(n, k, d)
                                for n, k, d in datagen.schema_columns()))
    sample = datagen.generate(spec["sample_rows"], spec["sample_seed"],
                              "cpu").numpy()
    work, _ = make_tpch_workload(schema, n_per_template=spec["queries_each"],
                                 seed=spec["workload_seed"])
    cuts = work.candidate_cuts()
    t0 = time.perf_counter()
    tree = build_greedy(sample, work, cuts,
                        GreedyConfig(min_block=spec["min_block"])).freeze()
    build_s = time.perf_counter() - t0
    arrays = tree.to_arrays()
    np.savez_compressed(BENCH / "layouts" / f"{config}.npz", **arrays)
    record = {
        "leaves": tree.n_leaves, "nodes": tree.n_nodes, "depth": tree.depth,
        "queries": len(work), "cuts": int(cuts.n_cuts),
        "advanced_cuts": int(cuts.n_adv),
        "build_s_cpu": round(build_s, 1), "sha256": layout.digest(arrays),
    }
    cfg["layout_record"] = record
    path.write_text(json.dumps(cfg, indent=2) + "\n")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="+")
    args = ap.parse_args(argv)
    for config in args.configs:
        print(config, build(config), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
