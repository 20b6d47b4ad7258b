"""LM serving CLI: batched prefill + greedy decode against KV/SSM caches.

  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch mamba2-780m \
      --batch 4 --prompt-len 64 --gen 32

Serves the arch's ``reduced()`` config (``max_positions=--max-seq``), as
the reference's ``repro.launch.serve_lm`` does, with weights drawn from
``--seed`` on the device.  ``--device`` defaults to the GPU and raises
without one.  Prefill runs at prompt length; its caches are copied into
fixed-capacity decode caches, which each step then updates in place.  It
prints the reference's lines and, last, a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.engine.plan import resolve_device
from repro_torch.models import common, model
from repro_torch.train import steps


def make_batch(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
               device) -> dict:
    """The reference's prompts (and stub frames / patches) from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, prompt_len))
           .astype(np.int32)}
    if cfg.is_encdec:
        out["frames"] = (0.01 * rng.standard_normal(
            (batch, 16, cfg.d_model))).astype(np.float32)
    if cfg.n_image_patches:
        out["patches"] = (0.01 * rng.standard_normal(
            (batch, cfg.n_image_patches, cfg.d_model))).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _clock(device: torch.device):
    """(mark, ms between two marks): CUDA events on the card, read after
    one synchronize at the end; the host clock on the CPU."""
    if device.type == "cuda":
        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return mark, lambda a, b: a.elapsed_time(b)
    return time.perf_counter, lambda a, b: (b - a) * 1e3


def generate(params, cfg: ModelConfig, batch: dict, gen: int,
             max_seq: int) -> dict:
    """Prefill ``batch`` then ``gen - 1`` greedy decode steps.

    → {"tokens" (B, gen) int32, "prefill_logits" (B, V), "logits" (B,
    gen-1, V) of each step, "prefill_ms", "step_ms" (a list)}.
    """
    b, plen = batch["tokens"].shape
    if plen + gen - 1 > max_seq:
        raise ValueError(f"prompt {plen} + {gen - 1} steps exceed the "
                         f"cache's {max_seq} positions")
    dev = batch["tokens"].device
    mark, ms = _clock(dev)
    t0 = mark()
    logits_last, prefill_caches = model.prefill(params, batch, cfg)
    t1 = mark()
    caches, _ = model.init_caches(cfg, b, max_seq, dev)
    caches = _splice(cfg, caches, prefill_caches, plen)
    del prefill_caches
    tok = torch.argmax(logits_last, dim=-1).to(torch.int32)[:, None]
    out, logits, marks = [tok], [], [mark()]
    for i in range(gen - 1):
        tok, lg, caches = steps.serve_step(params, caches, tok, plen + i, cfg)
        out.append(tok)
        logits.append(lg)
        marks.append(mark())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {
        "tokens": torch.cat(out, dim=1),
        "prefill_logits": logits_last,
        "logits": (torch.stack(logits, dim=1) if logits else
                   logits_last.new_zeros((b, 0, logits_last.shape[-1]))),
        "prefill_ms": ms(t0, t1),
        "step_ms": [ms(a, c) for a, c in zip(marks, marks[1:])],
    }


def _splice(cfg: ModelConfig, caches, prefill_caches, plen: int):
    """Copy prefill-emitted K/V (n_groups, B, KV, plen, hd) into the decode
    caches' first ``plen`` positions, in place; mamba slots take (state,
    conv) whole; enc-dec cross caches are the prefill's own (its frames)."""
    if cfg.is_encdec:
        for k in ("k", "v"):
            caches[k][..., :plen, :].copy_(prefill_caches[k])
        for k in ("cross_k", "cross_v"):
            caches[k] = prefill_caches[k].to(caches[k].dtype)
        return caches
    for slot, c in caches.items():
        pc = prefill_caches[slot]
        if "k" in c:
            c["k"][..., :plen, :].copy_(pc["k"])
            c["v"][..., :plen, :].copy_(pc["v"])
        else:
            c["state"].copy_(pc["state"])
            c["conv"].copy_(pc["conv"])
    return caches


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-32b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without "
                         "one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced(max_positions=args.max_seq)
    params, _ = model.init_model(common.make_generator(args.seed, dev), cfg)
    batch = make_batch(cfg, args.batch, args.prompt_len, args.seed, dev)
    res = generate(params, cfg, batch, args.gen, args.max_seq)

    gen = res["tokens"].cpu().numpy()
    t_decode = sum(res["step_ms"]) / 1e3
    tps = args.batch * (args.gen - 1) / max(t_decode, 1e-9)
    step_ms = t_decode / max(args.gen - 1, 1) * 1e3
    print(f"prefill: {args.batch}×{args.prompt_len} in "
          f"{res['prefill_ms']:.0f}ms")
    print(f"decode: {args.gen-1} steps, {tps:.1f} tok/s "
          f"({step_ms:.1f} ms/step)")
    print("sample generations:", gen[:, :8].tolist())
    print(json.dumps({
        "arch": cfg.name, "device": str(dev), "batch": args.batch,
        "prompt_len": args.prompt_len, "gen": args.gen,
        "prefill_ms": res["prefill_ms"], "decode_ms_per_step": step_ms,
        "tokens_per_s": tps, "tokens_shape": list(gen.shape),
        "in_vocab": bool(((gen >= 0) & (gen < cfg.vocab)).all()),
    }))
    return gen


if __name__ == "__main__":
    main()
