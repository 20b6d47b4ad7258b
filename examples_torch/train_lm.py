"""End-to-end LM training on the qd-tree data pipeline, on the PyTorch
port, as ``examples/train_lm.py`` does through the JAX package.

Default: a fast reduced run.  The documented end-to-end configuration
trains a ~100M-parameter qwen-family model for a few hundred steps — pass
``--hundred-m`` on a machine with the cycles:

  PYTHONPATH=src python examples_torch/train_lm.py              # quick demo
  PYTHONPATH=src python examples_torch/train_lm.py --hundred-m \
      --steps 300                                               # ~100M params

The data tier is the paper's contribution: records are laid out by a
greedy qd-tree, a curation query selects the mixture, and the pipeline
skips non-matching blocks before any I/O.  The step runs on ``--device``
(default: the GPU).
"""

import argparse

from repro_torch.launch import train as train_driver


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.hundred_m:
        # ~103M params: 12L × d1024 (qwen-family reduced, full vocab
        # embedding shrunk to keep the embedding from dominating)
        argv = [
            "--arch", "qwen1.5-32b", "--layers", "12", "--d-model", "1024",
            "--steps", str(args.steps or 300),
            "--batch", "8", "--seq", "512", "--rows", "200000",
        ]
    else:
        argv = [
            "--arch", "qwen1.5-32b",
            "--steps", str(args.steps or 30),
            "--batch", "8", "--seq", "128",
        ]
    argv += ["--device", args.device]
    if args.ckpt_dir:
        argv += ["--ckpt-dir", args.ckpt_dir]
    history = train_driver.main(argv)
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.3f} → {last:.3f}")
    assert last < first, "training did not reduce loss"
    print("train_lm OK")


if __name__ == "__main__":
    main()
