"""Batched serving on the PyTorch port: prefill a prompt batch, decode
with KV/SSM caches, as ``examples/serve_lm.py`` does through the JAX
package.

  PYTHONPATH=src python examples_torch/serve_lm.py --arch mamba2-780m
  PYTHONPATH=src python examples_torch/serve_lm.py \
      --arch jamba-1.5-large-398b --device cpu

Exercises the same serve_step the decode_32k / long_500k dry-run cells
trace, on reduced configs — including the hybrid (attention + SSD-state)
cache path.
"""

import argparse

from repro_torch.launch import serve_lm as serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    gen = serve.main([
        "--arch", args.arch,
        "--batch", str(args.batch),
        "--prompt-len", "32",
        "--gen", str(args.gen),
        "--max-seq", "128",
        "--device", args.device,
    ])
    assert gen.shape == (args.batch, args.gen)
    print("serve_lm OK")


if __name__ == "__main__":
    main()
