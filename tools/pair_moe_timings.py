#!/usr/bin/env python3
"""Time the MoE layer's single-shard body (``models/mlp.py::_moe_local``)
of two checkouts on one GPU, in turns.

    python3 tools/pair_moe_timings.py PARENT_ROOT CHANGE_ROOT [--rounds N]

Each root is a checkout of the repository (its ``src/repro_torch``).  The
script runs one process a side, parent, change, change, parent, ... for
``--rounds`` pairs.  Each process draws one MoE layer of
qwen3-moe-235b-a22b (the expert-parallel widths: d_model 4096, 128
experts, top-8, expert d_ff 1536) and one of grok-1-314b (the ff-sharded
widths: 6144, 8 experts, top-2, d_ff 32768) at their published widths in
their dtypes (bf16 weights and compute, f32 router), seeded on the card,
and 8 × 128 tokens, as ``chip_smoke.py``'s ``lm_shard`` phase does; it
prints one JSON line: the median CUDA-event ms of REPS forward + backward
calls (grads of mean(y²) + aux by every weight and the input) after a warm
one, and whether two calls gave the same y, aux and grads bit for bit.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SIDE = r'''
import json, os, sys
root = sys.argv[1]
sys.path.insert(0, os.path.join(root, "src"))
import torch
from repro_torch.configs import get_config
from repro_torch.models import common, mlp
if not torch.cuda.is_available():
    sys.exit("no CUDA device")
dev = torch.device("cuda", 0)
REPS, TOKENS = 5, (8, 128)
out = {}
for key, arch in (("ep", "qwen3-moe-235b-a22b"), ("ff", "grok-1-314b")):
    cfg = get_config(arch)
    params, _ = mlp.init_moe(common.make_generator(0, dev), cfg)
    b, s = TOKENS
    x = torch.randn((b * s, cfg.d_model), device=dev,
                    generator=common.make_generator(1, dev)).to(
        common.cdtype(cfg))

    def run():
        ps = {k: v.detach().requires_grad_() for k, v in params.items()}
        xx = x.detach().requires_grad_()
        y, aux = mlp._moe_local(ps, xx, cfg)
        g = torch.autograd.grad((y.float() ** 2).mean() + aux,
                                list(ps.values()) + [xx])
        return [y.detach(), aux.detach(), *g]

    def bits(t):
        ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}
        t = t.contiguous()
        return t.view(ints[t.element_size()]) if t.is_floating_point() else t

    first = run()
    second = run()
    same = all(torch.equal(bits(a), bits(c)) for a, c in zip(first, second))
    del first, second
    times = []
    for _ in range(REPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    out[key] = {"ms": times[len(times) // 2], "all_ms": times,
                "repeats_bitwise": same}
    del params, x
    torch.cuda.empty_cache()
print(json.dumps(out))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    runs = {"parent": [], "change": []}
    order = []
    for r in range(args.rounds):
        order += (["parent", "change"] if r % 2 == 0
                  else ["change", "parent"])
    for side in order:
        root = os.path.abspath(getattr(args, side))
        proc = subprocess.run([sys.executable, "-c", SIDE, root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(side, runs[side][-1], flush=True)
    print(json.dumps({"order": order, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
