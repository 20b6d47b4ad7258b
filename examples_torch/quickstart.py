"""Quickstart on the PyTorch port: learn a qd-tree layout, persist blocks,
run queries.

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Walks the paper end-to-end on a synthetic ErrorLog-like workload through
the LayoutService lifecycle, as ``examples/quickstart.py`` does through
the JAX package: strategy-dispatched construction (builder registry), a
scored rebuild with hot swap, block-store persistence, and query routing
(`BID IN (...)`) with the Table 2 / Fig 5 metrics.  The engines run on
``--device`` (default: the GPU).  The last line is a JSON summary with
the exact scanned fractions.
"""

import argparse
import json
import tempfile

from repro_torch.core import rewards
from repro_torch.data import datagen, workload as wl
from repro_torch.data.blocks import BlockStore
from repro_torch.service import LayoutService, build_layout


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=40_000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--min-block", type=int, default=400)
    ap.add_argument("--wb-iters", type=int, default=10,
                    help="WOODBLOCK iterations (of 4 episodes)")
    args = ap.parse_args(argv)
    dev, mb = args.device, args.min_block
    wb = dict(n_iters=args.wb_iters, episodes_per_iter=4)

    # 1. data + workload -----------------------------------------------------
    schema, records = datagen.make_errorlog_int(args.rows, seed=0)
    work, _ = wl.make_errorlog_int_workload(schema, n_queries=args.queries,
                                            seed=0)
    cuts = work.candidate_cuts()  # Sec 3.4: pushed-down unary predicates
    print(f"{records.shape[0]:,} records, {len(work)} queries, "
          f"{cuts.n_cuts} candidate cuts")

    # 2. layouts via the builder registry -----------------------------------
    builds = {
        strategy: build_layout(records, work, strategy=strategy, cuts=cuts,
                               min_block=mb, device=dev, **cfg)
        for strategy, cfg in (
            ("range", dict(column=0)),  # ErrorLog default scheme
            ("greedy", {}),
            ("woodblock", wb),
        )
    }
    lb = rewards.selectivity_lower_bound(records, work)
    print("scanned: " + "  ".join(
        f"{s} {100*b.scanned_fraction:.2f}%" for s, b in builds.items()
    ) + f"  (selectivity lower bound {100*lb:.4f}%)")

    # 3. serve the best layout; rebuild-in-place hot-swaps improvements ------
    svc = LayoutService(builds["greedy"], device=dev)
    rep = svc.rebuild(records, work, strategy="woodblock", cuts=cuts,
                      min_block=mb, **wb)
    print(f"rebuild: live {100*rep.live_scanned:.2f}% vs candidate "
          f"{100*rep.candidate_scanned:.2f}% -> "
          f"{'swapped' if rep.swapped else 'kept'} (gen {svc.generation})")

    # 4. physical execution --------------------------------------------------
    with tempfile.TemporaryDirectory() as td:
        store = BlockStore.create(td, svc.tree, records, device=dev)
        r = store.scan_query(work.queries[0])
        print(f"query 0: read {r.blocks_read}/{store.tree.n_leaves} blocks "
              f"({r.bytes_read:,} bytes) → {r.rows.shape[0]} rows "
              f"in {1e3*r.wall_s:.1f} ms")
    print(json.dumps({
        "scanned": {s: b.scanned_fraction for s, b in builds.items()},
        "lower_bound": lb, "swapped": rep.swapped,
        "query0_rows": int(r.rows.shape[0]),
    }))
    print("quickstart OK")


if __name__ == "__main__":
    main()
