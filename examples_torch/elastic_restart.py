"""Fault tolerance on the PyTorch port: crash mid-training, resume from
checkpoint, and show block-level work stealing when a data worker fails,
as ``examples/elastic_restart.py`` does through the JAX package.

  PYTHONPATH=src python examples_torch/elastic_restart.py [--device cpu]

Resuming onto another mesh (elastic resharding) is the train CLI's
``--data``/``--model-par`` under ``torchrun``.
"""

import argparse
import os
import pathlib
import subprocess
import sys
import tempfile

from repro_torch.data.pipeline import ElasticBlockScheduler

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def crash_and_resume(args):
    with tempfile.TemporaryDirectory() as ckpt:
        base = [
            sys.executable, "-m", "repro_torch.launch.train",
            "--arch", "qwen1.5-32b", "--steps", str(args.steps),
            "--batch", "4", "--seq", "64", "--ckpt-dir", ckpt,
            "--ckpt-every", str(args.ckpt_every), "--rows", str(args.rows),
            "--device", args.device,
        ]
        resumed = args.fail_at // args.ckpt_every * args.ckpt_every
        print(f"== run 1: injected failure at step {args.fail_at} ==")
        r = subprocess.run(
            base + ["--fail-at", str(args.fail_at)], capture_output=True,
            text=True, env=_env(),
        )
        assert "injected failure" in (r.stdout + r.stderr), r.stderr[-2000:]
        print("crashed as expected; resuming…")
        print("== run 2: resume to completion ==")
        r = subprocess.run(base, capture_output=True, text=True, env=_env())
        assert r.returncode == 0, r.stderr[-2000:]
        assert f"resumed from step {resumed}" in r.stdout, r.stdout[-2000:]
        print([ln for ln in r.stdout.splitlines() if "resumed" in ln or
               "done" in ln])


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def work_stealing():
    print("== block-level work stealing ==")
    sched = ElasticBlockScheduler(list(range(12)), seed=0)
    w0 = [sched.next_block(0) for _ in range(5)]
    w1 = [sched.next_block(1) for _ in range(3)]
    print(f"worker0 holds {w0}, worker1 holds {w1}")
    lost = sched.fail(0)
    print(f"worker0 failed; re-queued blocks {lost} (metadata-only handoff "
          "— completeness means peers know block contents without reads)")
    stolen = [sched.next_block(1) for _ in range(len(lost))]
    assert sorted(stolen) == sorted(lost)
    print(f"worker1 stole {stolen}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--fail-at", type=int, default=12)
    ap.add_argument("--rows", type=int, default=20_000)
    args = ap.parse_args(argv)
    crash_and_resume(args)
    work_stealing()
    print("elastic_restart OK")


if __name__ == "__main__":
    main()
