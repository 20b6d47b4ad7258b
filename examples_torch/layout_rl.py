"""WOODBLOCK on the PyTorch port, in isolation: watch the RL agent learn a
layout (Fig. 8) and inspect the best tree's cuts (Fig. 9), as
``examples/layout_rl.py`` does through the JAX package.

  PYTHONPATH=src python examples_torch/layout_rl.py [--device cpu]
"""

import argparse
from collections import Counter

from repro_torch.core.woodblock.agent import WoodblockConfig, build_woodblock
from repro_torch.data import datagen, workload as wl


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=30_000)
    ap.add_argument("--queries", type=int, default=120)
    ap.add_argument("--iters", type=int, default=12)
    args = ap.parse_args(argv)

    schema, records = datagen.make_errorlog_ext(args.rows, seed=0)
    work, _ = wl.make_errorlog_ext_workload(schema, n_queries=args.queries,
                                            seed=0)
    cuts = work.candidate_cuts()

    res = build_woodblock(
        records, work, cuts,
        WoodblockConfig(min_block_sample=300, n_iters=args.iters,
                        episodes_per_iter=4),
        verbose=True, device=args.device,
    )
    print(f"\nbest scanned fraction: {100*res.best_scanned:.3f}% "
          f"after {res.n_episodes} episodes")
    print("learning curve (best % by episode):",
          [f"{100*p.best_scanned:.2f}" for p in res.curve[::8]])

    # Fig. 9: which columns did the agent cut?
    hist = Counter()
    for node in res.best_tree.nodes():
        if not node.is_leaf:
            kind = cuts.describe(node.cut_id).split()[0]
            hist[kind] += 1
    print("cut histogram (column → #cuts):", dict(hist.most_common()))
    print("layout_rl OK")


if __name__ == "__main__":
    main()
