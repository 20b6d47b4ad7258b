"""End-to-end training driver: qd-tree data pipeline → train loop.

The paper's layout engine is the data tier: records are laid out by a
greedy qd-tree into a block store (on the card, one ``fused_ingest``
launch), a curation query selects the training mixture and the qd-tree
prunes non-matching blocks before any I/O (one ``query_intersect``
launch); blocks feed the elastic scheduler → tokenizer → train step.

The driver trains the arch's ``reduced()`` config unless ``--full-arch``
is given.  ``--device`` defaults to the GPU and raises without one.  With
``--ckpt-dir`` it resumes from the latest checkpoint there, skipping the
batches the restored steps consumed (the data cursor), so a resumed run's
losses continue an uninterrupted one's.

The step runs under a ``(data, model)`` mesh, as the reference's: one
rank by default (a one-rank process group, where the state's leaves are
plain tensors unless ``--dtensor-leaves``), or ``--data`` × ``--model-par``
ranks under ``torchrun --nproc-per-node N`` (``nccl`` on the GPUs,
``gloo`` with ``--device cpu``); a world size other than data × model is
refused.  Every rank builds the same data tier and draws the same
batches; each keeps its shards.  Rank 0 prints the log and, last, a JSON
summary.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-32b \
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --data 2 --model-par 2 --device cpu --rows 20000 --steps 4
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import greedy
from repro_torch.core.query import InAtom, Query
from repro_torch.data import datagen, workload as wl
from repro_torch.data.blocks import BlockStore
from repro_torch.data.pipeline import PipelineConfig, QdTreePipeline
from repro_torch.engine.plan import resolve_device
from repro_torch.kernels import _build
from repro_torch.launch.mesh import init_process_group, make_smoke_mesh
from repro_torch.models import common, model
from repro_torch.sharding import specs as sh
from repro_torch.train import steps
from repro_torch.train.loop import (FailureInjector, LoopConfig,
                                    maybe_restore, train_loop)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.schedule import ScheduleConfig


def build_data_tier(tmp: str, n_rows: int, block: int, seed: int = 0,
                    device=None):
    """Synthetic corpus + workload → greedy qd-tree → block store, routed
    on ``device`` (None: the GPU)."""
    schema, records = datagen.make_errorlog_int(n_rows, seed=seed)
    work, _ = wl.make_errorlog_int_workload(schema, n_queries=50, seed=seed)
    cuts = work.candidate_cuts()
    tree = greedy.build_greedy(
        records, work, cuts, greedy.GreedyConfig(min_block=block)
    )
    store = BlockStore.create(
        pathlib.Path(tmp) / "blocks", tree.freeze(), records, device=device
    )
    return schema, store


def _pipeline(store, schema, batch: int, seq: int, vocab: int,
              curated: bool, epochs: int, log=print) -> QdTreePipeline:
    curation = None
    if curated:
        # the mixture filter: only valid events of the two dominant types
        curation = Query.conjunction([
            InAtom(schema.dim("event_type"), (0, 1)),
            InAtom(schema.dim("is_valid"), (1,)),
        ])
    pipe = QdTreePipeline(store, PipelineConfig(
        batch_size=batch, seq_len=seq, vocab=vocab,
        curation_query=curation, epochs=epochs,
    ))
    log(
        f"pipeline: {store.tree.n_leaves} blocks, "
        f"{pipe.blocks_skipped} skipped by the curation query"
    )
    return pipe


def _batches(pipe: QdTreePipeline, device):
    while True:
        for toks, labels in pipe:
            yield {
                "tokens": torch.from_numpy(np.ascontiguousarray(toks))
                .to(device),
                "labels": torch.from_numpy(np.ascontiguousarray(labels))
                .to(device),
            }


def batches_from_pipeline(store, schema, batch: int, seq: int, vocab: int,
                          curated: bool, epochs: int = 1_000_000,
                          device=None):
    """Infinite batch iterator with qd-tree block skipping, its tensors on
    ``device`` (None: the GPU)."""
    return _batches(_pipeline(store, schema, batch, seq, vocab, curated,
                              epochs), resolve_device(device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-32b")
    ap.add_argument("--full-arch", action="store_true",
                    help="use the full config")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=0,
                    help="override reduced layer count")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--rows", type=int, default=50_000)
    ap.add_argument("--no-curation", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (restart demo)")
    ap.add_argument("--data", type=int, default=1, help="data-axis size")
    ap.add_argument("--model-par", type=int, default=1,
                    help="model-axis size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without "
                         "one)")
    ap.add_argument("--dtensor-leaves", action="store_true",
                    help="DTensor state leaves on a one-rank mesh too")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dist.is_initialized():
        world = dist.get_world_size()
    if world != args.data * args.model_par:
        ap.error(f"--data {args.data} × --model-par {args.model_par} is not "
                 f"the world size {world}: run under torchrun "
                 f"--nproc-per-node {args.data * args.model_par}")

    owns_group = not dist.is_initialized()
    dev = init_process_group(args.device)
    rank = dist.get_rank()
    log = print if rank == 0 else (lambda *a, **k: None)
    mesh = make_smoke_mesh(data=args.data, model=args.model_par, device=dev)
    cfg = get_config(args.arch)
    if not args.full_arch:
        over = {}
        if args.layers:
            over["n_layers"] = args.layers
        if args.d_model:
            over["d_model"] = args.d_model
            over["head_dim"] = max(args.d_model // max(cfg.n_heads, 1), 8)
        cfg = cfg.reduced(**over)
    log(f"arch {cfg.name}: {cfg.n_layers}L d={cfg.d_model}, "
        f"mesh data={args.data} model={args.model_par}")

    ocfg = AdamWConfig(eight_bit=cfg.opt_8bit)
    scfg = ScheduleConfig(
        peak_lr=3e-4, warmup_steps=max(args.steps // 10, 2),
        total_steps=args.steps,
    )

    with tempfile.TemporaryDirectory(prefix="qdtree_data_") as tmp:
        schema, store = build_data_tier(
            tmp, n_rows=args.rows, block=2_000, seed=args.seed, device=dev
        )
        pipe = _pipeline(store, schema, args.batch, args.seq, cfg.vocab,
                         curated=not args.no_curation, epochs=1_000_000,
                         log=log)
        batch_shapes = {
            n: torch.empty((args.batch, args.seq), dtype=torch.int32,
                           device="meta") for n in ("tokens", "labels")}
        step_fn, shapes, state_sh, batch_sh = steps.jit_train_step(
            cfg, ocfg, scfg, mesh, sh.Rules.make(), batch_shapes,
            {"tokens": ("batch", None), "labels": ("batch", None)})
        leaves_dt = True if args.dtensor_leaves else None
        batches = (sh.place(b, batch_sh, leaves_dt)
                   for b in _batches(pipe, dev))

        state, start = maybe_restore(args.ckpt_dir, shapes, dev)
        if state is None:
            # every rank draws the same full state and keeps its shards
            state = steps.init_train_state(
                common.make_generator(args.seed, dev), cfg, ocfg)
            log("cold start")
        else:
            for _ in range(start):  # the data cursor: the batches consumed
                next(batches)
            log(f"resumed from step {start}")
        state = sh.place(state, state_sh, leaves_dt)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

        lcfg = LoopConfig(
            total_steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            log_every=5,
        )
        state, history = train_loop(
            step_fn, state, batches, lcfg, FailureInjector(args.fail_at),
            log=log,
        )
    log(
        f"done: step={int(state['step'])} "
        f"final loss={history[-1]['loss']:.4f}"
    )
    walls = [h["wall_s"] for h in history]
    warm = walls[1:] or walls  # the first step is the warm one
    step_ms = float(np.median(warm)) * 1e3
    log(json.dumps({
        "arch": cfg.name, "device": str(dev), "full_arch": args.full_arch,
        "mesh": {"data": args.data, "model": args.model_par},
        "dtensor_leaves": any(isinstance(x, sh.DTensor)
                              for x in model.leaves(state["params"])),
        "params": model.param_count(state["params"]),
        "batch": args.batch, "seq": args.seq,
        "microbatches": cfg.microbatches, "remat": cfg.remat,
        "opt_8bit": cfg.opt_8bit, "start": start,
        "steps": [h["step"] for h in history],
        "losses": [h["loss"] for h in history],
        "grad_norms": [h["grad_norm"] for h in history],
        "step_ms": [w * 1e3 for w in walls],
        "step_ms_median": step_ms,
        "tokens_per_s": args.batch * args.seq / (step_ms / 1e3),
        "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                    if dev.type == "cuda" else None),
        "blocks": store.tree.n_leaves, "blocks_skipped": pipe.blocks_skipped,
        # layout-kernel launches in this process (the data tier's; on the
        # CPU the plain versions run and count nothing)
        "launches": _build.launch_counts(),
    }))
    if owns_group:
        dist.destroy_process_group()
    return history


if __name__ == "__main__":
    main()
