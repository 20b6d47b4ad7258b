#!/usr/bin/env python3
"""How often one WOODBLOCK PPO update breaks an elementwise bound when it
is computed twice in another order or precision.

    PYTHONPATH=src python3 tools/ppo_conditioning.py [--device cpu|cuda]
        [--rows N] [--every K] [--min-block B] [--budget-s S] [--seed S]

The script builds a WOODBLOCK layout (``build_layout(strategy=
"woodblock")``) on ``records[::every]`` of the TPC-H-like table and the
workload ``chip_smoke.py`` uses, within ``--budget-s``, and keeps every
``ppo_update``'s inputs.  For each update it computes the update again
from those inputs and compares the parameters and Adam moments after it,
elementwise, with ``|a - b| <= ATOL + RTOL * |b|`` (``chip_smoke.py``'s
PPO_RTOL and PPO_ATOL):

* ``f32_vs_f64``: float32 against float64, both on the CPU;
* with ``--device cuda``, also ``card_vs_cpu_f32`` and
  ``card_vs_cpu_f64``: the card against the CPU in each precision.

It also counts, for every update, the (row, unit) pairs whose ReLU input
has another sign in float32 than in float64 (``relu_flips``).  It prints
one JSON line: per update its Adam step ``t``, each comparison's largest
difference and whether it held, and a summary of how many updates broke
the bound in each comparison.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys

RTOL, ATOL = 1e-4, 1e-6  # chip_smoke.py's PPO_RTOL, PPO_ATOL


def update(c: dict, device, dtype) -> list:
    """``ppo_update`` from the kept inputs ``c`` on ``device`` in
    ``dtype`` → the parameters, then the Adam moments, on the CPU."""
    from repro_torch.core.woodblock import ppo

    net = copy.deepcopy(c["net"]).to(device=device, dtype=dtype)
    opt = {s: {k: v.to(device=device, dtype=dtype)
               for k, v in c["opt"][s].items()} for s in ("m", "v")}
    batch = {k: v.to(device=device, dtype=dtype) if v.is_floating_point()
             else v.to(device) for k, v in c["batch"].items()}
    net, opt, _ = ppo.ppo_update(net, dict(opt, t=c["opt"]["t"]), batch,
                                 c["cfg"])
    return [p.detach().cpu() for p in net.parameters()] + [
        opt[s][k].cpu() for s in ("m", "v") for k in sorted(opt[s])]


def compare(got: list, want: list) -> dict:
    err, ok = 0.0, True
    for a, b in zip(got, want):
        diff = (a.double() - b.double()).abs()
        err = max(err, float(diff.max()))
        ok &= bool((diff <= ATOL + RTOL * b.double().abs()).all())
    return {"max_abs_err": err, "within": ok}


def relu_flips(c: dict) -> int:
    """(row, unit) pairs of real rows whose ReLU input has another sign in
    float32 than in float64, over both hidden layers."""
    import torch

    signs = []
    for dtype in (torch.float32, torch.float64):
        net = copy.deepcopy(c["net"]).cpu().to(dtype)
        x = c["batch"]["states"].cpu().to(dtype)
        h1 = net.fc1(x)
        h2 = net.fc2(torch.relu(h1))
        signs.append((h1 > 0, h2 > 0))
    real = (c["batch"]["weight"].cpu() > 0)[:, None]
    return sum(int(((a != b) & real).sum())
               for a, b in zip(signs[0], signs[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--rows", type=int, default=400_000)
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--min-block", type=int, default=40)
    ap.add_argument("--budget-s", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.core.woodblock import ppo
    from repro_torch.data.datagen import make_tpch_like
    from repro_torch.data.workload import make_tpch_workload
    from repro_torch.service import build_layout

    if args.device == "cuda" and not torch.cuda.is_available():
        sys.exit("--device cuda: no CUDA device")
    torch.set_num_threads(args.threads)
    schema, records = make_tpch_like(args.rows, seed=args.seed)
    work, _ = make_tpch_workload(schema, n_per_template=10, seed=args.seed)
    cuts = work.candidate_cuts()
    kept, orig = [], ppo.ppo_update

    def keep(net, opt, batch, cfg):
        kept.append({"net": copy.deepcopy(net), "opt": copy.deepcopy(opt),
                     "batch": batch, "cfg": cfg})
        return orig(net, opt, batch, cfg)

    ppo.ppo_update = keep
    try:
        build_layout(records[::args.every], work, strategy="woodblock",
                     cuts=cuts, min_block=args.min_block, seed=args.seed,
                     device=args.device, time_budget_s=args.budget_s)
    finally:
        ppo.ppo_update = orig
    f32, f64 = torch.float32, torch.float64
    rows = []
    for c in kept:
        cpu32, cpu64 = update(c, "cpu", f32), update(c, "cpu", f64)
        row = {"t": c["opt"]["t"] + 1, "relu_flips": relu_flips(c),
               "f32_vs_f64": compare(cpu32, cpu64)}
        if args.device == "cuda":
            row["card_vs_cpu_f32"] = compare(update(c, "cuda", f32), cpu32)
            row["card_vs_cpu_f64"] = compare(update(c, "cuda", f64), cpu64)
        rows.append(row)
    pairs = [k for k in rows[0] if k not in ("t", "relu_flips")] if rows \
        else []
    summary = {k: {"updates_outside": sum(not r[k]["within"] for r in rows),
                   "max_abs_err": max(r[k]["max_abs_err"] for r in rows)}
               for k in pairs}
    print(json.dumps({"device": args.device, "torch": torch.__version__,
                      "sample_rows": int(records[::args.every].shape[0]),
                      "cuts": cuts.n_cuts, "updates": len(rows),
                      "rtol": RTOL, "atol": ATOL, "summary": summary,
                      "updates_with_relu_flips": sum(
                          r["relu_flips"] > 0 for r in rows),
                      "per_update": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
