#!/usr/bin/env python3
"""Drive the port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py [--rows N]

At the slice's full size (a 40M-row TPC-H-like table, 150-query workload,
greedy layout of 724 blocks learned from a 1% sample), through the entry
points a user calls — ``LayoutEngine(tree)`` on the GPU: ``warm_ingest``
+ ``ingest`` (one ``fused_ingest`` launch a batch into a running
accumulator on the device), ``route`` (one ``route_descend`` launch),
``route_queries``, ``route_query`` and ``skip_stats``
(``query_intersect``).  The main path also ingests and routes the table
into a finer layout (1,250 blocks learned from an 8,000-row sample, built
in a second process while the rest runs), whose aggregates do not fit a
block's shared memory, so ``fused_ingest`` takes its leafwise design
there (route once, sort the rows by leaf, fold each leaf's rows with one
owner: four kernels), and ``route`` its prefix kernel (the tree's BFS
prefix in shared memory, the deeper levels through L1 and L2).
It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` first,
and checks:

* each kernel (the four ``fused_ingest`` designs and the three
  ``route_descend`` kernels, each forced too) equals its plain PyTorch
  version on the
  card, exactly: on small random trees with every cut kind, on the finer
  layout, and at the main path's shapes; ``eval_cuts`` →
  ``locate_leaf``, off the main path since ``route`` descends directly,
  are still built, launched and checked;
* the running accumulator folded over uneven batches (one a single row,
  one starting at an unaligned row) equals the plain version over their
  concatenation and the numpy oracle (``fused_ingest_ref``);
* the whole 40M-row ingest's tightened descriptions equal the numpy
  oracle's (``IncrementalTightener`` over the same batches, on host
  threads), and the finer layout's equal the plain torch path's;
* route's block ids equal ``fused_step``'s, the two-kernel form's
  (``eval_cuts`` → ``locate_leaf``) and the numpy oracle's on both
  layouts; ``route_query`` equals ``route_queries``, and the query hits
  and per-conjunct scan counts equal the numpy backend's;
* each path of the main path (ingest, route, query), counted from 0 just
  before it, launched its kernels; ``route`` launched its layout's planned
  ``route_descend`` kernel once a call and nothing else, by the counters
  and in a trace; a warm engine builds no plan;
* a traced ingest runs exactly one ``fused_ingest`` kernel a batch and
  copies aggregates to the host once, not once a batch.

Then this slice's paths, each counted from 0 just before it, over the same
table and layout:

* trees past one block's shared memory (``BIG_TREES``: 1,300 to 20,000
  leaves grown by random legal splits of the 1% sample): one batch
  through the plan's design (the leafwise one, each of its four kernels
  once), a counted path a tree; the leafwise design, the global kernel
  and the cluster kernel forced (2 or 16 blocks, in two ranges at 20,000
  leaves, one launch a batch), each equal to the plain version and timed
  in turns, and each leafwise stage held to its plain version; at 8,000
  leaves a batch all in one leaf through the leafwise design; at 20,000
  the whole table
  ingested through ``LayoutEngine.ingest``, equal to the first draft's
  accumulators over the same batches; at 8,000 and 20,000 leaves (``BIG_ROUTE_TREES``)
  ``LayoutEngine.route`` of one batch a counted path of its own
  (``big_tree_route_<leaves>``, one launch of the planned prefix kernel),
  each route kernel forced, equal to the plain version and the fold's
  block ids and timed in turn, and at 20,000 the whole table routed
  batch by batch, equal to the global kernel's ids;
* sharded ingest (``sharded_ingest``, batches of 2**20): thread shards at
  k = 1, 2, 4, 8 (each on its own CUDA stream) and process shards at
  k = 4, 2 (spawned workers on the card, the table staged once); each
  merged state equals the single-stream ingest's and the numpy oracle's,
  one ``fused_ingest`` launch a batch (the workers report theirs), one
  copy back a shard (a trace at k = 4); the two-pass (``fused=False``)
  path, one ``route_descend`` a batch, on a 4M-row prefix;
* spill ingest (``ingest(buffers=...)``) of a 4,194,304-row prefix:
  buffer sizes equal the block sizes, and sampled blocks equal a host
  stable sort of the oracle's ids, row for row; its wall and, from a
  trace, its split into kernel, sort and copy;
* the block store of that prefix: ``write_store`` into a temporary
  directory, then ``scan_query`` of 10 queries (one a template), each
  equal to a brute-force ``Query.evaluate`` over the prefix;
* ``autotune_fused`` on one batch, persisted under ``build/``; the tuned
  geometry's whole-table ingests equal the oracle, timed beside the
  analytic plan's;
* the range (on ``l_shipdate``) and bottom-up baselines, built on the 1%
  sample in another process: their Eq. 1 on the card equals the numpy
  backend's, and one batch routed through each equals the numpy route;
  printed beside the qd-tree's on the same sample.

Then the layout lifecycle, each path counted from 0:

* WOODBLOCK on the greedy tree's 1% sample: ``TreeEnv``'s cut matrix is
  one ``eval_cuts`` launch, equal to ``preds.eval_cuts`` (the kernel timed
  at that shape against its plain version and its bound);
  ``build_layout(strategy="woodblock")`` within a 10 s budget (block ids
  and Eq. 1 hits equal numpy's); one ``ppo_update`` on the card against
  the CPU's in float64 at a stated tolerance (float32's gap recorded); episodes, policy steps (one a tree
  level) and updates timed;
* the service: an observed ingest (the per-leaf counts on the card) whose
  every batch's WindowStat equals the host probe's, with one accumulator
  copy back in a trace; ``LayoutService.ingest`` of the whole table at
  the default batch; ``benchmarks/drift_rebuild.py``'s scenario at the
  table's scale through ``LayoutService.auto_rebuilder`` (no rebuild
  failed, each ingest call's state equal to the numpy oracle's for its
  generation, no plan
  builds outside a swap but each call's description plan, a rebuild
  deployed after the shift within 1.2x a greedy rebuild); a rebuild on a
  ``drift-rebuild`` thread under concurrent routing, a timed swap,
  rollback and release, each followed by route and route_queries against
  numpy; a tracker-driven two-replica deploy whose cheapest routing
  equals the numpy backend's.

Then the serving tier and the entry points built on it, each path counted
from 0:

* ``serve`` (``QueryServer`` over ``LayoutService`` on the whole table's
  greedy layout, the 150 queries as the templates of a Zipf(1.1) mix, as
  ``benchmarks/serving.py`` runs it): 40 sync rounds of 64 queries with a
  greedy rebuild on the 1% sample (the drift scenario's shifted workload)
  swapped in at round 20; then 4 client threads × 400 queries through the
  async dispatcher while the main thread swaps in another layout. Every
  response equals the numpy route on its generation, no response is
  stale, no plan is built outside the swap, one ``query_intersect``
  launch an engine dispatch, and the standing workloads' operands stay
  cached; the hit path's ms against one engine dispatch of the same
  batch, the closed loop's qps and p50/p99;
* ``pipeline``: ``QdTreePipeline`` over the prefix's block store, curated
  by 3 workload queries: the rows behind every batch equal a brute-force
  filter of the prefix, in the scheduler's block order; records/s;
* ``coordinator``: a ``FleetCoordinator`` at cadence 4 folding the prefix
  from 4 worker threads (two partials each) and one worker that leaves
  mid-stream, then ``LayoutService.ingest`` with
  ``IngestOptions(shards=4, coordinator=)``: both publish the single
  stream's and the numpy oracle's descriptions and block sizes; fold ms;
* ``cli``: ``python -m repro_torch.launch.ingest`` (400,000 rows, 2
  shards, coordinator, tracker, drift, a store) and ``python -m
  repro_torch.launch.serve`` (30,000 rows, 4 s, ``--workload auto``) as
  subprocesses on the card, side by side: both exit 0; serve shows no
  stale response, no plan built while serving and its swap note.

Then the LM serving path, counted from 0 (it launches none of the
repo's kernels: plain torch ops, as the JAX LM stack has no Pallas
kernel):

* ``lm_serve``: starcoder2-3b and mamba2-780m at full width and depth in
  their own dtypes (float32 params, bf16 compute), weights drawn on the
  card, through ``serve_lm.generate`` at batch 4, prompt 64, 32 tokens,
  a 256-position cache: prefill ms, decode ms a step, tokens/s, peak
  device memory, parameters, model flops a token; tokens in the
  vocabulary and finite logits; then the same weights in float32, whose
  teacher-forced logits at positions 64.. equal the decode steps'; the
  ten archs at ``reduced()`` (MoE at capacity 8, a 160-token prompt that
  takes the chunked attention) on the card against the CPU port from the
  same weights, every step's logits and the greedy tokens; and ``python
  -m repro_torch.launch.serve_lm`` at its defaults as a subprocess on the
  card (exit 0).

Then the LM training path (the JAX training stack has no Pallas kernel
either; its data tier launches ``fused_ingest`` and ``query_intersect``):

* ``lm_train``: ``python -m repro_torch.launch.train --arch <a>
  --full-arch --steps 8`` for starcoder2-3b (2 microbatches) and
  mamba2-780m as subprocesses on the card, at the CLI's defaults (batch
  8, sequence 128, a 50,000-row errorlog table laid out by a greedy
  qd-tree into a block store, curation on), remat, float32 params, bf16
  compute, fp32 AdamW: exit 0, 8 finite losses, the data tier's kernels
  launched; step ms (median of steps 2-8), tokens/s, MFU against
  989.4 TFLOP/s, peak GB, the step's bound; one starcoder2-3b step
  traced in this process (busy share, device ops, split into forward,
  backward and optimizer); float32 at full width, the gradients in m
  after step 1 with 2 microbatches against 1, and remat on against off
  at ``reduced()``; the ten reduced archs, 3 steps on the card against
  the CPU (the CPU halves in the pool); and the CLI at reduced size
  crashed at step 12 with checkpoints every 5 steps, resumed from step 10
  to 16, its losses against an uninterrupted run's.  Every CLI run goes
  through the CLI's one-rank (data 1, model 1) mesh.  The CLI's five runs
  go one after another on a thread from the kernel build on, while the
  host makes the table and the layouts and the card is otherwise idle
  (the full-width ones timed there, beside that host work); the main
  path waits for them.

Then the sharding path (the JAX sharding has no Pallas kernel), counted
from 0, over a one-rank NCCL process group on the card:

* ``lm_shard``: one MoE layer at published widths in bf16 (qwen3-moe-
  235b-a22b's, 128 experts, top-8, expert d_ff 1536: the expert-parallel
  body; grok-1-314b's, 8 experts, top-2, d_ff 32768: the ff-sharded
  body) on 8 × 128 tokens, forward and backward through ``moe_forward``
  under a (data 1, model 1) mesh — its all-to-all, all-gather and psum
  real NCCL calls, seen in a trace — equal to ``_moe_local`` bit for bit
  (y, aux, every gradient, with default algorithms, each body repeating
  itself bit for bit); mamba2-780m at full width through
  ``jit_train_step`` on (pod 1, data 1, model 1), 4 plain and 4
  compressed steps (the int8 payload through NCCL), the last losses
  within 0.15, step ms side by side, the sync's wire bytes against
  float32; and starcoder2-3b at full width through ``jit_train_step`` on
  (data 1, model 1), 3 steps with the state's leaves as plain tensors and
  3 as DTensors, the losses bit for bit, step ms and peak GB each.
* ``dryrun``: ``python -m repro_torch.launch.dryrun`` as subprocesses on
  the host from the kernel build on (fake CUDA tensors over a fake
  process group, no card): starcoder2-3b x decode_32k on the production
  16x16 mesh with its cost variants, qwen3-moe-235b-a22b x train_4k
  ``--cost-only`` (the EP all-to-all in its 1- and 2-group variants) and
  mamba2-780m x decode_32k on a (1, 1) mesh; each exits 0 with a finite
  per-device peak.  In this process, mamba2-780m's decode step for real
  at its published widths (3.4 GB of float32 params, 9.8 GB of SSM state
  at batch 128), placed as the dry-run places it on a one-rank NCCL
  (1, 1) mesh: ``max_memory_allocated`` above the phase's start against
  the dry-run's predicted peak, within DRYRUN_PEAK_RATIO.

Then the port's examples and its qdlint:

* ``examples``: the five ``examples_torch/`` scripts (quickstart,
  layout_rl, train_lm, serve_lm, elastic_restart) at the reduced sizes
  of ``EXAMPLES`` (``tests/test_torch_examples.py`` runs them at the same
  on the CPU), as subprocesses on the card in three lanes started beside the lifecycle phases; and
  ``python -m repro_torch.analysis --self-test`` and its scan of
  ``src/repro_torch`` against ``qdlint-torch-baseline.json`` on the host.
  Each exits 0 (an example prints its ``<name> OK`` line); each one's exit
  code and seconds are printed.

Then it times: route and query latencies (median and spread of warm
calls, host clock; route split into its kernel, from a trace, and the
ids' copy back), whole-table ingests on fresh trees, one ingest under
``torch.profiler`` (the device's busy share), the fold of the running
accumulator into the tightener (once an ingest), and each kernel against
its plain version (the leafwise design, the finer layout's plan, in turns
with ``fused_ingest_cluster`` and ``fused_ingest_global``, forced there,
and its four kernels' own device times from a trace).
It exits non-zero on the first failure, without a CUDA device, and when
the package is not beside it.  Output, before the
last line: the card's name and power limit, build seconds, one
``{"metrics": ...}`` JSON line (keys ``serve``, ``pipeline``,
``coordinator``, ``cli``, ``examples``, ``lm_serve``, ``lm_train``,
``lm_shard``, ``dryrun``, ``big_trees``, and ``phase_s`` for every
phase)
and one ``{"kernels": [...]}`` JSON line (launches, median CUDA-event
time, bound, plain-version time, max difference per kernel; for each of
the leafwise design's four kernels, which one wrapper call launches
together, its device time from a trace, its stage's own bound and plain
version, and ``torch.cumsum``'s time beside the scan).  The last line is ``{"ok": true, "device":
{...}}``.  ``--rows`` cuts the row count (the only cut allowed; it is
printed).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FULL_ROWS = 40_000_000
BATCH = 1 << 20
SAMPLE_EVERY = 100  # a 1% sample for the greedy build
MIN_BLOCK = 400  # in sample records: ~40k rows a block at full size
FINE_SAMPLE = 8_000  # TPC-H-like rows the finer layout is learned from
FINE_MIN_BLOCK = 5  # ... giving 1,250 blocks, 250 KB of aggregates
# trees past one block's shared memory, grown by random legal splits of
# the 1% sample: the plan takes the leafwise design on each; forced, the
# cluster kernel takes two blocks of 32 warps, two of 17, 16
# blocks, and 16 blocks in two ranges
BIG_TREES = (1_300, 1_800, 8_000, 20_000)
# the designs forced on each big tree, timed in turns in this order and back
BIG_FORCED = ("leafwise", "global", "cluster")
# the big tree a batch all in one leaf is folded on by the leafwise design
ONE_LEAF_TREE = 8_000
ORACLE_ROWS = 1 << 18
ORACLE_CHUNK = 1 << 18  # rows a host thread routes at a time
ROUTE_QUERY_N = 10  # queries routed one at a time on the main path
LAT_REPS = 10  # warm calls per latency
TRACE_TRIES = 3  # traces of one window, at most, when events were dropped
INGEST_REPS = 5  # untraced whole-table ingests on fresh trees
FOLD_REPS = 5  # timed folds of one stream's accumulator
FOLD_HOST_REPS = 200  # well inside the card's queue of launches
FINE_TIMEOUT_S = 900  # the finer layout's build, at most
SEED = 0
SHARD_THREADS = (1, 2, 4, 8)  # thread-shard counts over the whole table
SHARD_PROCS = (4, 2)  # process-shard counts (4 first: the pool then serves 2)
SHARD_REPS = 3  # timed sharded ingests a configuration, after the checked one
TWO_PASS_ROWS = 1 << 22  # the fused=False shard path's prefix
STORE_ROWS = 1 << 22  # the spill ingest's and the block store's prefix
SPILL_REPS = 2  # untraced whole-table spill ingests
SPILL_CHECK_BLOCKS = 5  # blocks held row for row to the oracle's ids
STORE_QUERIES = 10  # workload queries scanned from the block store
TUNED_REPS = 2  # whole-table ingests with each geometry, alternated
RANGE_COLUMN = 0  # l_shipdate: the range baseline's partitioning column
BASELINE_ROUTE_ROWS = 1 << 16  # sample rows routed through each baseline
BASELINE_TIMEOUT_S = 600  # the baselines' build, at most
WOODBLOCK_BUDGET_S = 10  # build_layout(strategy="woodblock", time_budget_s)
COPY_REPS = 3  # copies back of the env's matrix in each form, alternated
# one PPO update on the card against the CPU, both in float64: sums in
# another order, then one Adam step of at most lr = 3e-4 a parameter.  In
# float32 the update is not continuous in its inputs: a ReLU input within
# rounding of 0 takes a row's gradient through the unit or not, and
# Adam's m / sqrt(v) scales a gradient at its rounding floor to a step of
# up to lr: on the CPU alone, float32 against float64 breaks this bound in
# a few updates of a build (tools/ppo_conditioning.py).  The float32 pair
# is recorded.
PPO_RTOL, PPO_ATOL = 1e-4, 1e-6
SHIPDATE, EXTENDEDPRICE = 0, 5  # the drift scenario's two query columns
DRIFT_QUERIES, DRIFT_FRAC = 20, 0.04  # benchmarks/drift_rebuild.py's
RESERVOIR = 400_000  # rows a drift rebuild trains on: the 1% sample's size
ORACLE_RATIO = 1.2  # recovered scanned fraction against a greedy rebuild
OBSERVE_REPS = 3  # observed and unobserved whole-table ingests, alternated
CHECK_ROWS = 1 << 16  # rows routed against numpy around each swap
REPLICA_ROUNDS = 4  # serving rounds of each workload the tracker records
SERVE_ROUNDS, SERVE_BATCH = 40, 64  # benchmarks/serving.py's phase 1
SERVE_SWAP_AT = 20  # the sync round a rebuild is swapped in
SERVE_ZIPF = 1.1  # the mix's skew over the 150 templates
HIT_REPS = 10  # hit-path and engine-dispatch timings
SERVE_CLIENTS, SERVE_PER_CLIENT = 4, 400  # its phase 2: the closed loop
SERVE_SWAP_AFTER = 400  # closed-loop queries served before the hot swap
PIPELINE_QUERIES = 3  # curation queries over the prefix's block store
PIPELINE_MIN_ROWS = 4096  # rows a curation query is expected to match
PIPELINE_BATCH, PIPELINE_SEQ, PIPELINE_VOCAB = 256, 64, 1 << 15
COORD_WORKERS, COORD_CADENCE = 4, 4  # fleet worker threads, fold cadence
COORD_BATCH = 1 << 18  # rows a worker routes at a time
CLI_INGEST_ROWS, CLI_SERVE_ROWS, CLI_SERVE_S = 400_000, 30_000, 4
CLI_TIMEOUT_S = 300  # each CLI subprocess, at most
CLI_DEVICE_ARGS: tuple = ()  # the CLIs' default device: the GPU
# the examples' reduced sizes (tests/test_torch_examples.py runs them at
# these on the CPU), and the port's qdlint on the host
EXAMPLES = {
    "quickstart.py": ("--rows", "8000", "--queries", "40", "--min-block",
                      "200", "--wb-iters", "1"),
    "layout_rl.py": ("--rows", "5000", "--queries", "40", "--iters", "2"),
    "train_lm.py": (),
    "serve_lm.py": ("--arch", "jamba-1.5-large-398b"),
    "elastic_restart.py": ("--steps", "6", "--ckpt-every", "2",
                           "--fail-at", "4", "--rows", "10000"),
}
QDLINT = {
    "qdlint_self_test": ("--self-test",),
    "qdlint_scan": ("src/repro_torch", "--baseline",
                    "qdlint-torch-baseline.json"),
}
EXAMPLES_TIMEOUT_S = 300  # each example, at most
EXAMPLES_THREADS = "2"  # each example's CPU threads, beside the main path
# three lanes, each one run after another, of about 50 s each on the card
# (the restart demo starts two train CLIs): they end within the ~75 s of
# the lifecycle phases they run beside
EXAMPLE_LANES = (("elastic_restart.py",), ("quickstart.py", "train_lm.py"),
                 ("layout_rl.py", "serve_lm.py", *QDLINT))
# the LM serving path: two models at full width and depth, in their own
# dtypes, at the serving CLI's defaults
LM_FULL = ("starcoder2-3b", "mamba2-780m")
LM_BATCH, LM_PROMPT, LM_GEN, LM_MAX_SEQ = 4, 64, 32, 256
# full width in float32 (TF32 off): teacher-forced logits against the
# decode steps' (30 / 48 layers, sums in another order; logits up to
# ~4.7 in magnitude, 6.2e-06 and 2.28e-05 apart at most on an H100)
LM_F32_RTOL, LM_F32_ATOL = 1e-4, 1e-4
# the ten reduced archs, float32 on the card against the CPU port (at
# most 2.46e-05 apart, jamba, on an H100); a prompt longer than twice
# attn_chunk (64) takes the chunked attention
LM_SMALL_PROMPT, LM_SMALL_GEN = 160, 32
LM_CARD_RTOL, LM_CARD_ATOL = 1e-4, 1e-4
LM_GAP_TOL = 2 * LM_CARD_ATOL  # a greedy pick may differ below this gap
LM_CLI_TIMEOUT_S = 300
LM_HOST_THREADS = 4  # the reduced archs' CPU halves, beside the card's
LM_TRACE_STEPS = 4  # decode steps under torch.profiler, a full model
LM_TRACE_TOP = 5  # ops listed by device time and by host time
LM_OP_NAME = 64  # characters of an op's name kept in the listing
# the LM training path: the two full models through the train CLI at its
# defaults (batch 8, sequence 128, a 50,000-row table, curation on)
LM_TRAIN_STEPS = 8
LM_DTENSOR_STEPS = 3  # steps with DTensor leaves: each ~2x the plain one
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128
LM_TRAIN_TOKENS = LM_TRAIN_BATCH * LM_TRAIN_SEQ
LM_TRAIN_TIMEOUT_S = 300
LM_CLI_WAIT_S = 900  # the train CLI's five runs, at most
# weights an embedding gathers from, or read in float32: never cast whole
LM_UNCAST = ("tok_embed", "pos_embed", "enc_pos", "dec_pos", "conv_w",
             "router")
# float32 at full width, 2 microbatches against 1: m after the first step
# on these leaves (the sums of g run in another order), each against its
# own max |m|
LM_F32_LEAVES = (("tok_embed",), ("layers", 0, "slot0", "mix", "wq"),
                 ("layers", 0, "slot0", "mlp", "w_up"),
                 ("layers", 29, "slot0", "mix", "wo"),
                 ("layers", 29, "slot0", "mlp", "w_down"), ("head",))
LM_MB_RTOL = 1e-4
LM_REMAT_RTOL = 1e-6  # recomputing a group's forward: the same kernels
# the ten reduced archs, float32 on the card against the CPU after
# LM_TRAIN_CARD_STEPS steps: leaves against their own max |x|, plus an
# absolute floor for a leaf whose gradient is noise (a key bias), which
# Adam turns into a step of ~lr either way
LM_TRAIN_CARD_STEPS = 3
# the fp32 archs' peak lr (warmup 1).  The int8 archs train at lr 0: the
# reference's int8 moments round v to 0 where m is not, and an entry whose
# next gradient is 0 (an expert no token reached, an embedding row of no
# token in the batch) then steps by m̂/eps, so by step 3 the card and the
# CPU part by far more than rounding (grok at lr 1e-3 on an H100)
LM_TRAIN_CARD_LR = 1e-3
LM_TRAIN_CARD_RTOL, LM_TRAIN_CARD_ATOL = 1e-4, 1e-6
# crash and resume through the CLI at reduced size
LM_RESUME_STEPS, LM_CKPT_EVERY, LM_FAIL_AT = 16, 5, 12
# a resumed run and a run with DTensor leaves repeat the plain run's
# losses bit for bit: no op of the LM step accumulates with atomics (the
# MoE's combine sums each token's rows in a fixed order)
LM_RESUME_RTOL = 0.0

# H100 SXM (NVIDIA data sheet): HBM rate, and the float32 rate outside the
# tensor cores, taken as the rate of the kernels' int32 compares/atomics
# the sharding path (lm_shard): one rank, an NCCL group on the card
LM_SHARD_EP = "qwen3-moe-235b-a22b"  # 128 experts, top-8: the EP path
LM_SHARD_FF = "grok-1-314b"  # 8 experts, top-2: the ff-sharded path
LM_SHARD_TOKENS = (8, 128)  # the MoE layers' batch × sequence
LM_SHARD_REPS = 2  # timed forward + backward calls a path, after a warm one
LM_SHARD_COMPRESS = "mamba2-780m"  # the compressed step, at full width
LM_SHARD_STEPS = 4
LM_SHARD_LOSS_TOL = 0.15  # the reference's bound (tests/test_sharding.py)
# the dry-run CLI's cells, run on the host as subprocesses (fake CUDA
# tensors over a fake process group; the card is not used): a decode cell
# on the production 16x16 mesh with its cost variants, the EP MoE's cost
# variants (its all-to-all in collectives_1g/2g), and the "check" cell's
# decode on a (1, 1) mesh, whose prediction the card checks
DRYRUN_CELLS = {
    "decode": ("starcoder2-3b", "decode_32k", ()),
    "moe_cost": ("qwen3-moe-235b-a22b", "train_4k", ("--cost-only",)),
    "check": ("mamba2-780m", "decode_32k", ("--mesh", "1,1", "--no-cost")),
}
DRYRUN_TIMEOUT_S = 600
DRYRUN_DEVICE = "cuda"  # the fake tensors' device
DRYRUN_NICE = 10  # the records yield the host to the main path's work
# the fake account against the card's max_memory_allocated, both above
# the same start and over the same ops: the allocator rounds each block up
# to 512 B and cuBLAS takes a workspace the account does not see, tens of
# MB against a 13.8 GB peak; 5% either way is far outside those
DRYRUN_PEAK_RATIO = (0.95, 1.05)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989.4e12  # dense bf16 on the tensor cores

FUSED = "src/repro_torch/kernels/csrc/fused_ingest.cu"
# kernels/_build.py::FUSED_KERNELS[4], the leafwise design's, in launch order
LEAFWISE_KERNELS = ("fused_ingest_leafwise_route", "fused_ingest_leafwise_scan",
                    "fused_ingest_leafwise_scatter",
                    "fused_ingest_leafwise_fold")
FUSED_REF = "src/repro/kernels/fused_ingest.py:213"
KERNEL_SOURCES = {
    "eval_cuts": ("src/repro_torch/kernels/csrc/eval_cuts.cu",
                  "src/repro/kernels/route_records.py:114"),
    "locate_leaf": ("src/repro_torch/kernels/csrc/locate_leaf.cu",
                    "src/repro/kernels/route_records.py:198"),
    # each computes what the two Pallas kernels compose: records → block ids
    **{name: ("src/repro_torch/kernels/csrc/route_descend.cu",
              "src/repro/kernels/route_records.py:114; "
              "src/repro/kernels/route_records.py:198")
       for name in ("route_descend_shared", "route_descend_global",
                    "route_descend_prefix")},
    "fused_ingest_shared": (FUSED, FUSED_REF),
    "fused_ingest_cluster": (FUSED, FUSED_REF),
    "fused_ingest_global": (FUSED, FUSED_REF),
    # the leafwise design's four kernels compute, in turn, the same fold
    **{name: (FUSED, FUSED_REF) for name in LEAFWISE_KERNELS},
    "query_intersect": ("src/repro_torch/kernels/csrc/query_intersect.cu",
                        "src/repro/kernels/query_intersect.py:94"),
}
VARIANTS = ("shared", "global")  # eval_cuts' and locate_leaf's
FUSED_VARIANTS = ("shared", "cluster", "leafwise", "global")
# route_descend's kernels forced, (variant, warps, staged nodes): the prefix
# kernel also with the root alone staged, so every level but the first
# reads the node array through L1 and L2
ROUTE_FORCED = (("shared",), ("global",), ("prefix",), ("prefix", None, 1))
# kernels off the main path: ``route`` no longer goes through eval_cuts and
# locate_leaf; fused_ingest_global takes only trees past the leafwise
# design's reach (the autotuner's candidates launch it), and
# fused_ingest_cluster and route_descend_global are forced only
OFF_PATH = ("eval_cuts", "locate_leaf", "fused_ingest_global",
            "fused_ingest_cluster", "route_descend_global")
# the big trees routed too: a counted path each through the plan's kernel
# (route_descend_prefix), each route kernel forced and timed in turn, and
# the whole table routed through the last
BIG_ROUTE_TREES = (8_000, 20_000)


def fused_launches(counts: dict) -> int:
    """Batches ``fused_ingest`` folded in a launch count, by any of its
    designs (the leafwise design's four kernels count once a batch)."""
    from repro_torch.kernels import fused_ingest as fk

    return fk.batches_folded(counts)


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def require_cuda():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    return torch.device("cuda", torch.cuda.current_device())


def fine_layout(seed: int) -> dict:
    """The finer layout's arrays (run in a second process)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.greedy import GreedyConfig, build_greedy
    from repro_torch.data.datagen import make_tpch_like
    from repro_torch.data.workload import make_tpch_workload

    schema, sample = make_tpch_like(FINE_SAMPLE, seed=seed)
    work, _ = make_tpch_workload(schema, n_per_template=10, seed=seed)
    tree = build_greedy(sample, work, work.candidate_cuts(),
                        GreedyConfig(min_block=FINE_MIN_BLOCK))
    return tree.freeze().to_arrays()


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def stream_ms(fn, calls: int = 10, reps: int = 10) -> float:
    """Device ms a call of ``fn``: ``calls`` calls back to back between two
    CUDA events (the host enqueues ahead of the card, so a wrapper's host
    side hides behind the kernels before it), the median over ``reps``,
    after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def spread(times: list) -> dict:
    return {"median": float(np.median(times)), "min": min(times),
            "max": max(times), "n": len(times)}


def host_ms(fn, reps: int) -> dict:
    """Host-clock ms of ``fn`` (calls that end on the host): median and
    spread over ``reps`` warm calls, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return spread(times)


def trace_counts(prof) -> dict:
    """From a profiler trace: the union of all device activity (kernels,
    copies, fills) in ms, the ``fused_ingest`` kernels' ms, the batches
    they folded (each design's first kernel runs once a batch), and the
    device-to-host copies."""
    import torch

    from repro_torch.kernels import fused_ingest as fk

    firsts = [names[0] for names in fk.KERNEL_NAMES.values()]
    spans, kernel_ms, kernels, d2h = [], 0.0, 0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        if "fused_ingest" in ev.name:
            kernel_ms += (ev.time_range.end - ev.time_range.start) / 1e3
            kernels += any(name in ev.name for name in firsts)
        if "DtoH" in ev.name:
            d2h += 1
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return {"busy_ms": busy / 1e3, "fused_kernel_ms": kernel_ms,
            "fused_kernels": kernels, "d2h_copies": d2h}


def traced_kernels(fn, reps: int) -> dict[str, list]:
    """Device ms of each kernel of the repo's libraries (by counter name)
    over ``reps`` calls of ``fn`` under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans: dict[str, list] = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in _build.LAUNCH_NAMES:
            if name in ev.name:
                spans.setdefault(name, []).append(
                    (ev.time_range.end - ev.time_range.start) / 1e3)
    return spans


def traced_kernel_sample(fn, name: str, reps: int) -> dict:
    """Device times of the kernel ``name`` over ``reps`` calls of ``fn``
    under ``torch.profiler``: the median of the events the trace kept, and
    their count.  The trace may drop some (seven of ten 0.1 ms
    ``eval_cuts`` kernels at the env's shape on the H100, all ten of them
    at 2**20 rows once, one of ten 0.02 ms ``query_intersect`` kernels in
    every trace of one run), so the launches are counted by the wrappers
    instead: each traced window must launch exactly ``reps`` of ``name``
    and no other kernel of the repo.  A trace that kept none is taken
    again, at most TRACE_TRIES traces in all; fails if the last kept none,
    or shows another kernel of the repo."""
    from repro_torch.kernels import _build

    for attempt in range(TRACE_TRIES):
        before = _build.launch_counts()
        spans = traced_kernels(fn, reps)
        after = _build.launch_counts()
        launched = {k: after[k] - before[k] for k in _build.LAUNCH_NAMES
                    if after[k] != before[k]}
        require(launched == {name: reps},
                f"{reps} calls launched {launched}; expected {reps} {name}")
        if spans:
            break
        log(f"trace {attempt + 1} of {name} kept none of {reps} kernels")
    require(set(spans) == {name} and 0 < len(spans[name]) <= reps,
            f"the trace shows {({k: len(v) for k, v in spans.items()})} "
            f"kernels for {reps} calls of {name}")
    return {"ms": float(np.median(spans[name])), "events": len(spans[name])}


def max_abs_err(got, want) -> float:
    """Largest |difference| over matching integer tensors (exact: 0.0)."""
    import torch

    err = 0.0
    for a, b in zip(got, want):
        require(a.shape == b.shape and a.dtype == b.dtype,
                f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
                f"{tuple(b.shape)} {b.dtype}")
        if a.numel():
            d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
            err = max(err, float(d))
    return err


def random_case(seed: int, m: int = 50_000):
    """A small random tree over every cut kind (all six advanced ops)."""
    from repro_torch.core import predicates as preds
    from repro_torch.core import query as qry
    from repro_torch.core.qdtree import singleton_tree

    rng = np.random.default_rng(seed)
    schema = preds.Schema((
        preds.Column("x", "numeric", 10_000),
        preds.Column("c", "categorical", 7),
        preds.Column("y", "numeric", 10_000),
        preds.Column("k", "categorical", 40),
    ))
    records = np.stack([
        rng.integers(0, 10_000, m), rng.integers(0, 7, m),
        rng.integers(0, 10_000, m), rng.integers(0, 40, m),
    ], axis=1).astype(np.int32)
    b = preds.CutTableBuilder(schema)
    for c in rng.integers(1, 10_000, 16):
        b.add_range(0, preds.OP_LT, int(c))
        b.add_range(2, preds.OP_LT, int(c))
    for _ in range(4):
        b.add_in(1, rng.choice(7, 3, replace=False).tolist())
        b.add_in(3, rng.choice(40, 11, replace=False).tolist())
    for op in range(6):
        b.add_adv(0, op, 2)
    cuts = b.build()
    tree = singleton_tree(schema, cuts, np.arange(m))
    M = preds.eval_cuts(records, cuts)
    leaves = [tree.root]
    for _ in range(60):
        node = leaves[int(rng.integers(0, len(leaves)))]
        legal = [c for c in range(cuts.n_cuts)
                 if 0 < M[node.rows, c].sum() < node.size]
        if legal:
            leaves = [n for n in leaves if n is not node]
            leaves += list(tree.split(node, int(rng.choice(legal)),
                                      cut_matrix=M))
    queries = tuple(
        qry.Query.conjunction([
            qry.RangeAtom(0, preds.OP_LT, int(rng.integers(1, 10_000))),
            qry.InAtom(3, tuple(int(v) for v in rng.choice(40, 5, False))),
            qry.AdvAtom(0, int(rng.integers(0, 6)), 2,
                        polarity=bool(rng.integers(2))),
        ])
        for _ in range(20)
    )
    return tree.freeze(), records, qry.Workload(schema, queries)


def route_ops(tree, dev):
    from repro_torch.engine import plan as tplan

    return tplan.to_device(tplan.pack_route_constants(tree), dev)


def query_args(tree, wt, dev):
    from repro_torch.engine import plan as tplan
    from repro_torch.kernels import ops as kops

    layout = kops.query_layout(tree.schema, tree.cuts.n_adv)
    return (tplan.to_device(tplan.pack_leaf_descs(tree, layout), dev),
            tplan.to_device(kops.pack_workload(wt, layout), dev),
            tplan.to_device(layout, dev))


def fused_err(ops, batches, variant) -> float:
    """A running accumulator folded over ``batches`` by one kernel, against
    the plain version over their concatenation: block ids and aggregates."""
    import torch
    from repro_torch.kernels import fused_ingest as fk

    with fk._forced(variant):
        acc = fk.IngestAccumulator(ops)
    plain = fk.IngestAccumulator(ops)
    bids = torch.cat([acc.fold(b, bids=True) for b in batches])
    want = fk.fused_ingest_plain(torch.cat(batches), plain)
    return max_abs_err([bids, *acc.tensors()], [want, *plain.tensors()])


def route_forced(rec, ops, variant, warps=None, prefix=None):
    """Block ids by one ``route_descend`` kernel, ``variant`` forced (at
    ``warps`` a block and ``prefix`` staged nodes where given)."""
    from repro_torch.kernels import route_records as rk

    with rk._forced(variant, warps, prefix):
        plan = rk.route_plan(ops)
    require(plan.kernel == rk.VARIANTS[variant],
            f"route_descend planned kernel {plan.kernel} for {variant}")
    return rk.route(rec, {**ops, "route_plan": plan})


def compare_kernels(tree, rec, wt, dev, ctx: str,
                    variants=FUSED_VARIANTS) -> dict[str, float]:
    """Each kernel against its plain version on the same inputs (exact):
    both kernels of ``eval_cuts`` and ``locate_leaf``, each of
    ``route_descend``'s (ROUTE_FORCED), also against the two-kernel form,
    and each design of ``fused_ingest`` in ``variants``."""
    from repro_torch.kernels import fused_ingest as fk
    from repro_torch.kernels import query_intersect as qk
    from repro_torch.kernels import route_records as rk

    ops = route_ops(tree, dev)
    errs = {"eval_cuts": 0.0, "locate_leaf": 0.0}
    m_p = rk.eval_cuts_plain(rec, ops)
    two_plain = rk.locate_leaf_plain(m_p, ops)
    for v in VARIANTS:  # each kernel of the pair, forced
        with rk._forced(v):
            m_k = rk.eval_cuts(rec, ops)
            two_kernel = rk.locate_leaf(m_k, ops)
        errs["eval_cuts"] = max(errs["eval_cuts"], max_abs_err([m_k], [m_p]))
        errs["locate_leaf"] = max(errs["locate_leaf"],
                                  max_abs_err([two_kernel], [two_plain]))
    want = rk.route_plain(rec, ops)
    for forced in ROUTE_FORCED:
        got = route_forced(rec, ops, *forced)
        require(max_abs_err([got], [two_kernel]) == 0.0,
                f"{ctx}: route_descend {forced} differs from eval_cuts → "
                f"locate_leaf")
        name = rk.ROUTE_KERNELS[rk.VARIANTS[forced[0]]]
        errs[name] = max(errs.get(name, 0.0), max_abs_err([got], [want]))
    for v in variants:
        e = fused_err(ops, [rec], v)
        for name in fk.KERNEL_NAMES[fk.VARIANTS[v]]:
            errs[name] = e
    qargs = query_args(tree, wt, dev)
    errs["query_intersect"] = max_abs_err(qk.query_intersect(*qargs),
                                          qk.query_intersect_plain(*qargs))
    for name, e in errs.items():
        require(e == 0.0, f"{ctx}: {name} kernel differs from its plain "
                          f"version by {e}")
    return errs


def timed(fn, *args):
    """(fn(*args), its seconds on the host clock)."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def oracle_partial(tree, records: np.ndarray, workers: int):
    """The numpy oracle over ``records``: host accumulators
    (``IncrementalTightener`` on the numpy descent's block ids) over
    chunks on ``workers`` threads, merged.  Returns (bids, partial)."""
    from repro_torch.core.qdtree import IncrementalTightener
    from repro_torch.kernels.ref import fused_ingest_ref

    starts = range(0, records.shape[0], ORACLE_CHUNK)
    with ThreadPoolExecutor(workers) as ex:
        parts = list(ex.map(
            lambda s: fused_ingest_ref(tree, records[s:s + ORACLE_CHUNK]),
            starts,
        ))
    t = IncrementalTightener(tree)
    for _, p in parts:
        t.merge(p)
    return np.concatenate([b for b, _ in parts]), t.as_partial()


def running_fold(tree, rec_dev, records, bounds, dev, ctx, variants,
                 workers) -> float:
    """Uneven batches ``rec[bounds[i]:bounds[i+1]]`` folded into one
    accumulator by each kernel: equal to the plain version over their
    concatenation and to the numpy oracle."""
    from repro_torch.kernels import fused_ingest as fk

    ops = route_ops(tree, dev)
    batches = [rec_dev[s:e] for s, e in zip(bounds, bounds[1:])]
    want_bids, want = oracle_partial(tree, records[bounds[0]:bounds[-1]],
                                     workers)
    err = 0.0
    for v in variants:
        e = fused_err(ops, batches, v)
        require(e == 0.0, f"{ctx}: running fold ({v}) differs from the "
                          f"plain version over the concatenation by {e}")
        with fk._forced(v):
            acc = fk.IngestAccumulator(ops)
        bids = np.concatenate([acc.fold(b, bids=True).cpu().numpy()
                               for b in batches])
        require(np.array_equal(bids, want_bids),
                f"{ctx}: running fold ({v}) block ids vs the numpy oracle")
        got = acc.partial(tree)
        for f in ("counts", "lo", "hi", "cat", "adv"):
            require(np.array_equal(getattr(got, f), getattr(want, f)),
                    f"{ctx}: running fold ({v}) {f} vs the numpy oracle")
        err = max(err, e)
    return err


def leaf_depths(tree) -> np.ndarray:
    """(n_leaves,) number of cuts on each leaf's root path."""
    depth = np.zeros(tree.n_nodes, np.int64)
    for node in range(tree.n_nodes):  # BFS order: parents come first
        if tree.cut_id[node] >= 0:
            depth[tree.left[node]] = depth[tree.right[node]] = depth[node] + 1
    out = np.zeros(tree.n_leaves, np.int64)
    leaf = tree.leaf_bid >= 0
    out[tree.leaf_bid[leaf]] = depth[leaf]
    return out


def leaf_paths(tree) -> np.ndarray:
    """(n_leaves, depth) the cut ids on each leaf's root path, -1 past its
    end."""
    out = np.full((tree.n_leaves, max(tree.depth, 1)), -1, np.int64)
    paths = {0: []}
    for node in range(tree.n_nodes):  # BFS order: parents come first
        path = paths.pop(node)
        if tree.cut_id[node] >= 0:
            path = path + [int(tree.cut_id[node])]
            paths[int(tree.left[node])] = paths[int(tree.right[node])] = path
        else:
            out[tree.leaf_bid[node], :len(path)] = path
    return out


def path_sectors(tree, bids: np.ndarray, chunk: int = 1 << 18) -> int:
    """Distinct 32-byte sectors of the (m, n_cuts) uint8 predicate matrix
    that the rows' root paths read (row r, leaf ``bids[r]``): the least a
    descent over the matrix reads, since the card reads whole sectors."""
    paths, n_cuts, m = leaf_paths(tree), tree.cuts.n_cuts, bids.shape[0]
    seen = np.zeros((m * n_cuts + 31) // 32, bool)
    for s in range(0, m, chunk):
        p = paths[bids[s:s + chunk]]
        base = np.arange(s, s + p.shape[0], dtype=np.int64)[:, None] * n_cuts
        seen[((base + p) >> 5)[p >= 0]] = True
    return int(seen.sum())


def eval_table_bytes(ops) -> int:
    """What eval_cuts reads of its operands: the packed cuts and in_mask."""
    return sum(int(ops[k].numel() * ops[k].element_size())
               for k in ("cut_pack", "in_mask"))


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_bound(tree, ops, bids, m: int, d: int):
    """Least time of one fold of ``m`` records without block ids: the
    records, cut table and nodes read once, the accumulators read and
    written once; one operation per cut on each record's path and per
    aggregate it folds."""
    table = sum(int(v.numel() * v.element_size()) for k, v in ops.items()
                if k in ("cat_off", "in_mask", "adv", "cat_dims"))
    acc = tree.n_leaves * (8 + 4 * (2 * d + int(ops["cw"])
                                    + 2 * int(ops["aw"])))
    path = int(leaf_depths(tree)[bids].sum())
    n_cat = int(ops["cat_dims"].shape[0])
    return bound(m * d * 4 + table + 16 * tree.n_nodes + 2 * acc,
                 path + m * (2 * d + n_cat + int(ops["n_adv"]) + 1))


def leafwise_stage_err(acc, bids, n_leaves: int) -> dict:
    """Each stage of the leafwise design against its plain version, from
    the scratch one batch left in ``acc`` (forced leafwise, one fold of the
    rows whose block ids are ``bids``): the route's ids are ``bids`` (the
    caller holds them to the plain version); the scan's per-leaf counts are
    zero again and its offsets are the exclusive cumulative sum of
    ``torch.bincount``; the scatter's leaf order, each leaf's rows sorted,
    is ``torch.argsort(bids, stable=True)``.  The fold's output is the
    accumulators, held by the caller."""
    import torch

    (s,) = acc._scratch.values()
    m = bids.shape[0]
    hist = torch.bincount(bids.long(), minlength=n_leaves)
    first = torch.cat([torch.cumsum(hist, 0) - hist, hist.new_tensor([m])])
    ent = torch.sort(s["entries"][:m]).values  # (leaf, row) order
    return {
        "scan": max_abs_err([s["hist"], s["offsets"].long()],
                            [torch.zeros_like(s["hist"]), first]),
        "scatter": max_abs_err(
            [ent >> 32, ent & 0xFFFFFFFF],
            [torch.sort(bids).values.long(),
             torch.argsort(bids, stable=True)]),
    }


def one_leaf_batch(x, bids):
    """``x``'s rows of its busiest leaf (by ``bids``), repeated to as many
    rows as ``x``: every row of the batch lands in one leaf."""
    import torch

    busiest = int(torch.bincount(bids.long()).argmax())
    idx = torch.nonzero(bids == busiest).flatten()
    reps = -(-x.shape[0] // idx.shape[0])
    return x[idx.repeat(reps)[:x.shape[0]]].contiguous()


def big_tree_phase(ctx, cuts, x, counted) -> dict:
    """Trees past one block's shared memory (BIG_TREES leaves over the
    main path's schema and cuts, grown by random legal splits of the 1%
    sample): one batch folded by the plan's design, each tree a counted
    path of its own (``big_tree_<leaves>``) with one launch of each of its
    kernels; then the leafwise design, the cluster kernel (its own split,
    in ranges past the largest cluster) and the one-thread-a-record
    kernel, each forced, equal to the plain version too (block ids and all
    six accumulators) and timed in turns (BIG_FORCED, then again in
    reverse: 20 single calls between CUDA events, and :func:`stream_ms`),
    the leafwise stages each held to its plain version
    (:func:`leafwise_stage_err`), and each leafwise kernel's device ms
    from a trace beside its own bound (:func:`leafwise_stage_bounds`); the
    plain version's time and the function's bound.
    On ONE_LEAF_TREE leaves a batch all in one leaf through the leafwise
    design.  On
    the last tree the whole table ingested through ``LayoutEngine.ingest``
    (a counted path, ``big_tree_ingest_<leaves>``) equal to the first
    draft's accumulators, forced, over the same batches.  The
    BIG_ROUTE_TREES are routed too (:func:`big_tree_route`)."""
    import torch

    from repro_torch.core.qdtree import random_layout
    from repro_torch.kernels import fused_ingest as fk

    m, d = x.shape
    dev = ctx["dev"]
    out = {}
    for n_leaves in BIG_TREES:
        tree, grow_s = timed(random_layout, cuts, ctx["sample"], n_leaves,
                             SEED)
        require(tree.n_leaves == n_leaves,
                f"grew {tree.n_leaves} leaves, not {n_leaves}")
        ops = route_ops(tree, dev)
        acc = fk.IngestAccumulator(ops)
        plan = acc._launch
        want_plan = fk.layout_plan(fk.plan_shape(ops),
                                   fk.optin_bytes(dev.index))
        require(plan._replace(most=0) == want_plan,
                f"{n_leaves} leaves: plan {plan}, not {want_plan}")
        path = f"big_tree_{n_leaves}"
        bids = counted(path, lambda: acc.fold(x, bids=True))
        names = fk.KERNEL_NAMES[plan.kernel]
        require(ctx["path_launches"][path]
                == {k: int(k in names) for k in ctx["path_launches"][path]},
                f"{n_leaves} leaves: one batch launched "
                f"{ctx['path_launches'][path]}; expected one of each of "
                f"{names}")
        accs = {}
        for v in BIG_FORCED:
            with fk._forced(v):
                accs[v] = fk.IngestAccumulator(ops)
        require((accs["cluster"]._launch.ranges > 1)
                == (n_leaves == BIG_TREES[-1]),
                f"{n_leaves} leaves: cluster plan {accs['cluster']._launch}")
        plain = fk.IngestAccumulator(ops)
        want = [fk.fused_ingest_plain(x, plain), *plain.tensors()]
        err = {"plan": max_abs_err([bids, *acc.tensors()], want)}
        for v, a in accs.items():
            err[v] = max_abs_err([a.fold(x, bids=True), *a.tensors()], want)
        stage_err = leafwise_stage_err(accs["leafwise"], want[0], n_leaves)
        require(all(e == 0.0 for e in (*err.values(), *stage_err.values())),
                f"{n_leaves} leaves: the kernels differ from the plain "
                f"version by {err}, the leafwise stages by {stage_err}")
        times = {v: {"ms": [], "stream_ms": []} for v in accs}
        for v in [*accs, *reversed(accs)]:  # A, B, C, C, B, A
            times[v]["ms"].append(time_ms(lambda a=accs[v]: a.fold(x), 20))
            times[v]["stream_ms"].append(
                stream_ms(lambda a=accs[v]: a.fold(x)))
        plain_ms = time_ms(lambda: fk.fused_ingest_plain(x, plain,
                                                         bids=False), 1)
        bids_np = bids.cpu().numpy()
        bound_ms, bound_by = fused_bound(tree, ops, bids_np, m, d)
        stage_bounds = leafwise_stage_bounds(tree, ops, bids_np, m, d)
        stages = {k: {**v, "bound_ms": stage_bounds[k][0],
                      "bound_by": stage_bounds[k][1]}
                  for k, v in leafwise_stages(accs["leafwise"], x).items()}
        out[n_leaves] = {
            "grow_s": grow_s, "depth": tree.depth, "kernels": list(names),
            "plan": plan._asdict(),
            "forced_plans": {v: a._launch._asdict() for v, a in accs.items()},
            "max_abs_err": max(err.values()), "stage_err": stage_err,
            "stages": stages,
            "times": times, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "launches": {k: c for k, c in ctx["path_launches"][path].items()
                         if c}}
        log(f"{n_leaves} leaves (grown in {grow_s:.1f}s, depth "
            f"{tree.depth}): plan {plan} ({names}); forced {times} ms; "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms")
        if n_leaves == ONE_LEAF_TREE:
            out[n_leaves]["one_leaf"] = leafwise_one_leaf(ops, x, bids)
        del acc, accs, plain, want
        torch.cuda.empty_cache()
        if n_leaves in BIG_ROUTE_TREES:
            out[n_leaves]["route"] = big_tree_route(
                ctx, tree, ops, x, bids, counted,
                whole=n_leaves == BIG_ROUTE_TREES[-1])
            torch.cuda.empty_cache()
        if n_leaves == BIG_TREES[-1]:
            out[n_leaves]["whole_table"] = big_tree_ingest(ctx, tree, ops,
                                                           counted)
            torch.cuda.empty_cache()
    return out


def leafwise_stages(acc, x) -> dict:
    """Each leafwise kernel's device ms (median of the events a trace of
    LAT_REPS folds kept, and their count), the folds counted by the
    wrappers: LAT_REPS launches of each of the four and of nothing else.
    A trace that kept no event of one of them is taken again, at most
    TRACE_TRIES traces in all; fails if the last still kept none."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_ingest as fk

    names = fk.KERNEL_NAMES[fk.VARIANTS["leafwise"]]
    for attempt in range(TRACE_TRIES):
        before = _build.launch_counts()
        spans = traced_kernels(lambda: acc.fold(x), LAT_REPS)
        after = _build.launch_counts()
        launched = {k: after[k] - before[k] for k in _build.LAUNCH_NAMES
                    if after[k] != before[k]}
        require(launched == dict.fromkeys(names, LAT_REPS),
                f"{LAT_REPS} leafwise folds launched {launched}")
        require(set(spans) <= set(names), f"the trace shows {set(spans)}")
        if set(spans) == set(names):
            break
        log(f"trace {attempt + 1} of the leafwise folds kept no "
            f"{set(names) - set(spans)}")
    require(set(spans) == set(names),
            f"no trace kept every leafwise kernel: {set(spans)}")
    return {k: {"ms": float(np.median(spans[k])), "events": len(spans[k])}
            for k in names}


def leafwise_stage_bounds(tree, ops, bids: np.ndarray, m: int,
                          d: int) -> dict:
    """Each leafwise kernel's own bound on a fold of ``m`` rows whose
    block ids are ``bids``: the bytes its function must move (each input
    read once, each output written once) and its operations.  Route: the
    records, nodes and in_mask in, a row's id and slot and a leaf's count
    out; a cut a path level and a histogram add a row.  Scan: the counts
    in, the offsets out; an add a leaf.  Scatter: the ids, slots, offsets
    and counts in, the leaf order, the running counts (read and written)
    and the zeroed counts out; a store a row and an add a leaf.  Fold: the
    leaf order and the records in, the running min, max and bits read and
    written; as the function's bound, an operation an aggregate a row."""
    L, n_cat, n_adv = tree.n_leaves, int(ops["cat_dims"].shape[0]), \
        int(ops["n_adv"])
    words = L * 4 * (2 * d + int(ops["cw"]) + 2 * int(ops["aw"]))
    table = sum(int(v.numel() * v.element_size()) for k, v in ops.items()
                if k in ("cat_off", "adv", "cat_dims"))
    names = LEAFWISE_KERNELS
    return dict(zip(names, (
        bound(m * d * 4 + 16 * tree.n_nodes + int(ops["in_mask"].numel())
              + 8 * m + 4 * L, int(leaf_depths(tree)[bids].sum()) + m),
        bound(4 * L + 4 * (L + 1), L),
        bound(8 * m + 4 * (L + 1) + 4 * L + 8 * m + 16 * L + 4 * L, m + L),
        bound(8 * m + m * d * 4 + table + 2 * words,
              m * (2 * d + n_cat + n_adv)),
    )))


def leafwise_stage_plain(acc, x) -> dict:
    """Each leafwise kernel's plain PyTorch version, on the inputs one fold
    of ``x`` (no block ids) left in ``acc``'s scratch, held to what the
    kernel left there: its ms (median of 3 CUDA-event calls), its
    ``max_abs_err`` and, for the scan, the ms of the one PyTorch call that
    computes it (``torch.cumsum``; none computes another stage alone).
    Route: the ids and the per-leaf counts (its slots are the atomics'
    order: not compared); scan: the offsets; scatter, from the kernel's
    slots: the leaf order, exactly; fold, from the kernel's leaf order:
    the min, max and bits, which a repeated fold leaves as they are."""
    import torch

    from repro_torch.kernels import fused_ingest as fk
    from repro_torch.kernels import route_records as rk

    (s,) = acc._scratch.values()
    ops, dev = acc.ops, x.device
    m, L = x.shape[0], acc.lo.shape[0]
    ids, slots = s["ids"][:m], s["slots"][:m]
    offsets, entries = s["offsets"], s["entries"][:m]
    hist = torch.bincount(ids.long(), minlength=L).to(torch.int32)
    rows = torch.arange(m, device=dev)
    plain = fk.IngestAccumulator(ops)  # its tensors only: never folded

    def route():
        b = rk.route_plain(x, ops)
        h = torch.bincount(b.long(), minlength=L)
        order = torch.argsort(b, stable=True)
        sl = torch.empty_like(b)
        sl[order] = (rows - (torch.cumsum(h, 0) - h)[b[order]]).to(sl.dtype)
        return b, sl, h

    def scan():
        return torch.cat([hist.new_zeros(1),
                          torch.cumsum(hist, 0, dtype=torch.int32)])

    def scatter():
        ent = torch.empty(m, dtype=torch.int64, device=dev)
        ent[offsets[ids.long()].long() + slots.long()] = \
            (ids.long() << 32) | rows
        plain.counts.add_(hist)
        h = hist.clone()
        h.zero_()
        return ent

    def fold():
        fk.fold_plain(x[entries & 0xFFFFFFFF], (entries >> 32).int(), plain)

    b, _, h = route()
    fold()
    got = {
        "route": max_abs_err([b, h.int()], [ids, hist]),
        "scan": max_abs_err([scan()], [offsets]),
        "scatter": max_abs_err([scatter()], [entries]),
        "fold": max_abs_err(acc.tensors()[1:], plain.tensors()[1:]),
    }
    out = {}
    for name, stage, fn in zip(LEAFWISE_KERNELS, got, (route, scan, scatter,
                                                      fold)):
        out[name] = {"plain_ms": time_ms(fn, 3), "max_abs_err": got[stage],
                     "library_ms": None}
    out[LEAFWISE_KERNELS[1]]["library_ms"] = time_ms(
        lambda: torch.cumsum(hist, 0), 20)
    require(all(r["max_abs_err"] == 0.0 for r in out.values()),
            f"a leafwise stage differs from its plain version: {got}")
    return out


def leafwise_one_leaf(ops, x, bids) -> dict:
    """A batch of ``x``'s size, every row in one leaf, folded by the
    leafwise design (forced): equal to the plain version; and its ms."""
    from repro_torch.kernels import fused_ingest as fk

    skew = one_leaf_batch(x, bids)
    with fk._forced("leafwise"):
        acc = fk.IngestAccumulator(ops)
    plain = fk.IngestAccumulator(ops)
    want = [fk.fused_ingest_plain(skew, plain), *plain.tensors()]
    got = acc.fold(skew, bids=True)
    require(int(want[0].unique().numel()) == 1, "the batch spans leaves")
    err = max_abs_err([got, *acc.tensors()], want)
    require(err == 0.0, f"a batch in one leaf: the leafwise design differs "
                        f"from the plain version by {err}")
    ms = time_ms(lambda: acc.fold(skew), 20)
    log(f"a batch of {skew.shape[0]} rows in one leaf: leafwise {ms:.6f} ms")
    return {"rows": skew.shape[0], "max_abs_err": err, "ms": ms}


def big_tree_ingest(ctx, tree, ops, counted) -> dict:
    """The whole table ingested through ``LayoutEngine.ingest`` on the
    tree (a counted path, ``big_tree_ingest_<leaves>``: each of the plan's
    kernels once a batch, nothing else), its tightened descriptions equal
    to those of the first draft's accumulators, forced, over the same
    batches."""
    from repro_torch.core.qdtree import FrozenQdTree, IncrementalTightener
    from repro_torch.engine import LayoutEngine
    from repro_torch.kernels import fused_ingest as fk

    dev, slices = ctx["dev"], ctx["slices"]
    engine = LayoutEngine(FrozenQdTree.from_arrays(tree.to_arrays()),
                          device=dev)
    engine.warm_ingest(ctx["sizes"])
    path = f"big_tree_ingest_{tree.n_leaves}"
    rep = counted(path, lambda: engine.ingest(slices))
    names = fk.KERNEL_NAMES[fk.layout_plan(fk.plan_shape(ops), fk.optin_bytes(
        dev.index)).kernel]
    launched = ctx["path_launches"][path]
    require(rep.n_batches == len(slices) and launched == {
        k: len(slices) * (k in names) for k in launched},
        f"{path}: {rep.n_batches} batches launched {launched}; expected "
        f"each of {names} once a batch")
    with fk._forced("global"):
        acc_g = fk.IngestAccumulator(ops)
    for s in slices:
        acc_g.fold(s)
    ref = FrozenQdTree.from_arrays(tree.to_arrays())
    tightener = IncrementalTightener(ref)
    tightener.merge(acc_g.partial(ref))
    tightener.apply()
    require(leaves_equal(engine.tree, ref),
            f"{path}: the ingest's descriptions differ from the first "
            f"draft's over the same batches")
    log(f"{path}: {rep.n_records} rows in {rep.n_batches} batches, "
        f"{rep.wall_s:.3f}s, equal to the first draft's")
    return {"rows": rep.n_records, "batches": rep.n_batches,
            "wall_s": rep.wall_s, "launches": launched}


def big_fused_row(r: dict, variant: str, name: str) -> dict:
    """Kernel ``name`` of the fused design ``variant`` on a big tree, from
    :func:`big_tree_phase`'s result: medians of the design's times forced,
    launches on the tree's counted path, the error, bound and plain ms."""
    t = r["times"][variant]
    return {"ms": float(np.median(t["ms"])),
            "stream_ms": float(np.median(t["stream_ms"])),
            "launches": r["launches"].get(name, 0),
            "max_abs_err": r["max_abs_err"], "bound_ms": r["bound_ms"],
            "plain_ms": r["plain_ms"]}


def big_route_row(r: dict, name: str) -> dict:
    """Route kernel ``name`` on a big tree, from :func:`big_tree_route`'s
    result: medians of its times (None where it was not run: the shared
    kernel past a warp's fit), launches on the tree's counted path, the
    bound and the plain version's ms."""
    t = r["times"].get(name)
    return {"ms": t and float(np.median(t["ms"])),
            "stream_ms": t and float(np.median(t["stream_ms"])),
            "launches": r["launches"][name], "max_abs_err":
            r["max_abs_err"].get(name), "bound_ms": r["bound_ms"],
            "plain_ms": r["plain_ms"]}


def route_bound(tree, ops, bids: np.ndarray, m: int, d: int):
    """Least time of one route of ``m`` records: the records, the nodes and
    in_mask read once, 4 bytes of id a record written; one operation per
    cut on each record's path."""
    return bound(m * d * 4 + 16 * tree.n_nodes + int(ops["in_mask"].numel())
                 + m * 4, int(leaf_depths(tree)[bids].sum()))


def big_tree_route(ctx, tree, ops, x, bids, counted, whole: bool) -> dict:
    """A tree past the shared kernel's reach routed: ``LayoutEngine.route``
    of the batch ``x`` a counted path (``big_tree_route_<leaves>``) with one
    launch of the plan's kernel and nothing else; each route kernel forced
    (the prefix one, the global one, the shared one where a warp's tile
    fits beside the tree), each equal to the plain version and to the fold
    plan's block ids ``bids``, and timed in turns (each kernel, then each
    again in reverse: 20 single calls between CUDA events, and
    :func:`stream_ms`); the plain version's time and the bound.  With
    ``whole``, the whole table routed through the engine, batch by batch,
    equal to the global kernel's ids forced on the same batches."""
    import torch

    from repro_torch.engine import LayoutEngine
    from repro_torch.kernels import route_records as rk

    dev = ctx["dev"]
    m, d = x.shape
    optin = rk.optin_bytes(dev.index)
    planned = rk.descend_plan(tree.n_nodes, d, optin)
    name = rk.ROUTE_KERNELS[planned.kernel]
    engine = LayoutEngine(tree, device=dev)
    engine.route(x[:5])  # the tree plan, with the route plan in it
    path = f"big_tree_route_{tree.n_leaves}"
    got = counted(path, lambda: engine.route(x))
    launched = ctx["path_launches"][path]
    require(launched == {k: int(k in (name, "route_descend"))
                         for k in launched},
            f"{tree.n_leaves} leaves: engine.route launched {launched}; "
            f"expected one {name}")
    want = rk.route_plain(x, ops)
    require(np.array_equal(got, want.cpu().numpy())
            and torch.equal(want, bids),
            f"{tree.n_leaves} leaves: engine.route, the plain route and the "
            f"fold's block ids differ")
    forced = [("prefix",), ("global",)] + [("shared",)] * (
        rk.shared_fit(tree.n_nodes, d, optin) >= 1)
    runs, err, plans = {}, {}, {}
    for f in forced:
        with rk._forced(*f):
            plan = rk.route_plan(ops)
        kernel = rk.ROUTE_KERNELS[plan.kernel]
        o = {**ops, "route_plan": plan}
        err[kernel] = max_abs_err([rk.route(x, o)], [want])
        plans[kernel] = plan._asdict()
        runs[kernel] = (lambda o=o: rk.route(x, o))
    require(all(e == 0.0 for e in err.values()),
            f"{tree.n_leaves} leaves: route kernels differ from the plain "
            f"version by {err}")
    times = {k: {"ms": [], "stream_ms": []} for k in runs}
    for k in [*runs, *reversed(runs)]:  # A, B, B, A
        times[k]["ms"].append(time_ms(runs[k], 20))
        times[k]["stream_ms"].append(stream_ms(runs[k]))
    plain_ms = time_ms(lambda: rk.route_plain(x, ops), 1)
    bound_ms, bound_by = route_bound(tree, ops, want.cpu().numpy(), m, d)
    out = {"kernel": name, "plan": planned._asdict(), "forced_plans": plans,
           "max_abs_err": err, "times": times, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "launches": launched}
    log(f"{tree.n_leaves} leaves: route plan {planned} ({name}); {times} "
        f"ms; plain {plain_ms:.3f} ms, bound {bound_ms:.6f} ms")
    if whole:
        t0 = time.perf_counter()
        n = 0
        for s in ctx["slices"]:
            ids = engine.route(s)
            old = route_forced(s, ops, "global").cpu().numpy()
            require(np.array_equal(ids, old),
                    f"{tree.n_leaves} leaves: the whole table's route "
                    f"differs from the global kernel's at row {n}")
            n += s.shape[0]
        require(n == ctx["n_rows"], "the whole table was not routed")
        out["whole_table"] = {"rows": n, "batches": len(ctx["slices"]),
                              "wall_s": time.perf_counter() - t0}
        log(f"{tree.n_leaves} leaves: the whole table ({n} rows) routed "
            f"through engine.route equals the global kernel's ids")
    return out


def baseline_layouts(sample: np.ndarray, seed: int, n_blocks: int) -> dict:
    """The paper's baseline layouts over the greedy tree's 1% sample, built
    by the port's host code (run in a second process): the range layout at
    ``n_blocks`` blocks, and the bottom-up layout at the greedy tree's
    minimum block size.  Returns each layout's tree arrays, block ids and
    build seconds."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.baselines import bottom_up, partitioners
    from repro_torch.data.workload import make_tpch_workload
    from repro_torch.data.datagen import make_tpch_like

    schema, _ = make_tpch_like(1, seed=seed)
    work, _ = make_tpch_workload(schema, n_per_template=10, seed=seed)
    cuts = work.candidate_cuts()
    out = {}
    t0 = time.perf_counter()
    tree, bids = partitioners.range_layout(
        sample, schema, cuts, sample.shape[0] // n_blocks, RANGE_COLUMN)
    out["range"] = (tree.to_arrays(), bids, time.perf_counter() - t0)
    t0 = time.perf_counter()
    tree, bids = bottom_up.build_bottom_up(
        sample, work, cuts, bottom_up.BottomUpConfig(block_size=MIN_BLOCK))
    out["bottom_up"] = (tree.to_arrays(), bids, time.perf_counter() - t0)
    return out


def state_of(partial, n_leaves: int):
    """A merged ShardState's aggregates from a TightenPartial."""
    from repro_torch.engine.sharded import ShardState

    return ShardState(shard_ids=(0,), n_leaves=n_leaves,
                      counts=partial.counts, lo=partial.lo, hi=partial.hi,
                      cat=partial.cat, adv=partial.adv, n_batches=0,
                      n_records=0, chunks={})


def leaves_equal(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f)) for f in
               ("leaf_lo", "leaf_hi", "leaf_cat", "leaf_adv", "block_sizes"))


def shard_phase(ctx, counted) -> dict:
    """Sharded ingest of the device-resident table: thread shards at each
    k of SHARD_THREADS, process shards at each k of SHARD_PROCS (staged
    once a session, each worker's slice kept on the card), and the
    two-pass (``fused=False``) thread path on a prefix.  Every merged state
    equals the single-stream ingest's and the numpy oracle's, and the
    published tree the oracle's; one ``fused_ingest`` launch a batch; one
    copy back a shard (in a trace).  A run publishes the same tree every
    time, so the repetitions share one engine."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.qdtree import FrozenQdTree
    from repro_torch.engine import LayoutEngine
    from repro_torch.engine import sharded

    rec_dev, n_rows = ctx["rec_dev"], ctx["n_rows"]
    want_tree, untightened = ctx["oracle_tree"], ctx["untightened"]
    wants = {"single-stream": state_of(ctx["single_partial"],
                                       want_tree.n_leaves),
             "oracle": state_of(ctx["oracle_partial"], want_tree.n_leaves)}

    def check(rep, tree, what):
        for name, want in wants.items():
            require(sharded.states_bit_identical(rep.state, want),
                    f"{what}: merged state differs from the {name} state")
        require(leaves_equal(tree, want_tree),
                f"{what}: tightened tree differs from the oracle's")

    def run_thread(eng, k, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", sharded.PerformanceWarning)
            return sharded.sharded_ingest(eng, kw.pop("records", rec_dev), k,
                                          batch=BATCH, executor="thread",
                                          keep_state=True, **kw)

    out = {"thread": {}, "process": {}}
    for k in SHARD_THREADS:
        eng = LayoutEngine(FrozenQdTree.from_arrays(untightened))
        eng.warm_ingest(sharded.warm_sizes(n_rows, k, BATCH))
        torch.cuda.synchronize()
        path = f"shard_thread_{k}"
        rep = counted(path, lambda: run_thread(eng, k))
        check(rep, eng.tree, f"thread shards k={k}")
        launched = ctx["path_launches"][path]
        fused = fused_launches(launched)
        require(fused == rep.n_batches,
                f"thread shards k={k}: {fused} fused_ingest launches for "
                f"{rep.n_batches} batches")
        reps = [rep] + [run_thread(eng, k) for _ in range(SHARD_REPS)]
        out["thread"][k] = {
            "wall_ms": spread([r.wall_s * 1e3 for r in reps[1:]]),
            "merge_ms": spread([r.merge_s * 1e3 for r in reps[1:]]),
            "first_wall_ms": rep.wall_s * 1e3, "batches": rep.n_batches,
            "launches": launched}
        log(f"thread shards k={k}: wall ms {out['thread'][k]['wall_ms']}")
    # a traced run at k=4: one fused_ingest a batch, one copy back a shard
    eng = LayoutEngine(FrozenQdTree.from_arrays(untightened))
    eng.warm_ingest(sharded.warm_sizes(n_rows, 4, BATCH))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rep = run_thread(eng, 4)
    tr = trace_counts(prof)
    require(tr["fused_kernels"] == rep.n_batches,
            f"traced thread shards: {tr['fused_kernels']} fused_ingest "
            f"kernels for {rep.n_batches} batches")
    require(tr["d2h_copies"] == 4,
            f"traced thread shards k=4: {tr['d2h_copies']} copies back; "
            f"expected one a shard")
    out["thread_traced_k4"] = tr
    try:
        for k in SHARD_PROCS:
            eng = LayoutEngine(FrozenQdTree.from_arrays(untightened))
            t0 = time.perf_counter()
            with sharded.ProcessShardSession(eng, k, batch=BATCH) as sess:
                sess.stage(rec_dev)
                devices = set(sess.worker_devices().values())
                require(devices == {str(ctx["dev"])},
                        f"process shards k={k}: workers on {devices}, the "
                        f"parent on {ctx['dev']}")

                def run_process():
                    return sharded.sharded_ingest(
                        eng, None, k, batch=BATCH, session=sess,
                        keep_state=True)

                # the first round copies each worker's slice to the card
                run_process()
                setup_s = time.perf_counter() - t0
                path = f"shard_process_{k}"
                rep = counted(path, run_process)
                check(rep, eng.tree, f"process shards k={k}")
                worker = sess.stats()["launches"]
                fused = fused_launches(worker)
                require(fused == rep.n_batches,
                        f"process shards k={k}: {fused} fused_ingest "
                        f"launches in the workers for {rep.n_batches} "
                        f"batches")
                require(len(rep.shard_wall_s) == k, "one state a shard")
                ctx["worker_launches"].append(worker)
                reps = [run_process() for _ in range(SHARD_REPS)]
            out["process"][k] = {
                "wall_ms": spread([r.wall_s * 1e3 for r in reps]),
                "merge_ms": spread([r.merge_s * 1e3 for r in reps]),
                "first_wall_ms": rep.wall_s * 1e3, "setup_s": setup_s,
                "batches": rep.n_batches, "worker_launches": worker}
            log(f"process shards k={k}: wall ms "
                f"{out['process'][k]['wall_ms']}, set-up {setup_s:.1f}s")
    finally:
        sharded.shutdown_process_pool()
    # the two-pass path (route, then the host tightener) on a prefix
    n_pre = min(n_rows, TWO_PASS_ROWS)
    eng = LayoutEngine(FrozenQdTree.from_arrays(untightened))
    rep = counted("shard_two_pass", lambda: run_thread(
        eng, 2, records=rec_dev[:n_pre], fused=False))
    want = oracle_partial(FrozenQdTree.from_arrays(untightened),
                          ctx["records"][:n_pre], ctx["workers"])[1]
    require(sharded.states_bit_identical(
        rep.state, state_of(want, want_tree.n_leaves)),
        "two-pass thread shards differ from the numpy oracle")
    require(ctx["path_launches"]["shard_two_pass"]["route_descend"]
            == rep.n_batches, "two-pass shards: one route_descend a batch")
    out["two_pass"] = {"rows": n_pre, "wall_ms": rep.wall_s * 1e3,
                       "launches": ctx["path_launches"]["shard_two_pass"]}
    t4, p4 = out["thread"][4]["wall_ms"], out["process"][4]["wall_ms"]
    out["faster_at_k4"] = ("thread" if t4["median"] <= p4["median"]
                           else "process")
    out["default_on_gpu"] = sharded.CUDA_DEFAULT_EXECUTOR
    return out


def spill_trace(prof) -> dict:
    """A traced spill ingest's device time, ms: the fused_ingest kernels,
    the device-to-host copies, and the rest (the sort by block, counts and
    gather)."""
    import torch

    split = {"kernel_ms": 0.0, "copy_ms": 0.0, "sort_ms": 0.0}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = (ev.time_range.end - ev.time_range.start) / 1e3
        if "fused_ingest" in ev.name:
            split["kernel_ms"] += ms
        elif "DtoH" in ev.name:
            split["copy_ms"] += ms
        else:
            split["sort_ms"] += ms
    return split


def spill_phase(ctx, counted) -> tuple:
    """``ingest(buffers=...)`` over the whole table: sizes equal the block
    sizes, and sampled blocks equal a host stable sort of the oracle's
    block ids, row for row.  Returns (the buffers, their tree, metrics)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.qdtree import FrozenQdTree
    from repro_torch.data.blocks import BlockBuffers
    from repro_torch.engine import LayoutEngine

    slices, records = ctx["slices"], ctx["records"]
    oracle_bids = ctx["oracle_bids"]

    def one():
        eng = LayoutEngine(FrozenQdTree.from_arrays(ctx["untightened"]))
        eng.warm_ingest(ctx["sizes"])
        torch.cuda.synchronize()
        return eng, BlockBuffers.for_tree(eng.tree)

    eng, buf = one()
    rep = counted("spill", lambda: eng.ingest(slices, buffers=buf))
    n = len(slices)
    launched = ctx["path_launches"]["spill"]
    require(fused_launches(launched) == n,
            f"spill ingest: {launched} for {n} batches")
    require(np.array_equal(buf.sizes, rep.block_sizes)
            and np.array_equal(buf.sizes, ctx["oracle_tree"].block_sizes),
            "spill buffer sizes differ from the block sizes")
    require(leaves_equal(eng.tree, ctx["oracle_tree"]),
            "spill ingest: tightened tree differs from the oracle's")
    rng = np.random.default_rng(SEED)
    checked = sorted(int(b) for b in rng.choice(
        np.flatnonzero(buf.sizes), SPILL_CHECK_BLOCKS, replace=False))
    for b in checked:
        rows = records[np.flatnonzero(oracle_bids == b)]
        require(np.array_equal(buf.block(b), rows),
                f"spill block {b} differs from the oracle's rows")
    walls = []
    for _ in range(SPILL_REPS):
        e2, b2 = one()
        walls.append(e2.ingest(slices, buffers=b2).wall_s * 1e3)
    e3, b3 = one()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = e3.ingest(slices, buffers=b3)
    split = spill_trace(prof)
    log(f"spill ingest: {spread(walls)} ms; traced split {split}; blocks "
        f"{checked} equal the oracle's rows")
    return buf, eng.tree, {
        "wall_ms": spread(walls), "first_wall_ms": rep.wall_s * 1e3,
        "traced_wall_ms": traced.wall_s * 1e3, "traced_split_ms": split,
        "checked_blocks": checked, "launches": launched,
    }


def store_phase(ctx, counted, buf, tree, root) -> dict:
    """``write_store`` into ``root`` (a temporary directory, which the
    pipeline phase reads later), then ``scan_query`` of STORE_QUERIES
    workload queries: each scan's rows equal a brute-force
    ``Query.evaluate`` over the table, in block order, and no matching
    row lies in a block the query skipped."""
    from repro_torch.data.blocks import BlockStore

    records, schema = ctx["records"], tree.schema
    oracle_bids = ctx["oracle_bids"]
    t0 = time.perf_counter()
    buf.write_store(root, tree)
    write_s = time.perf_counter() - t0
    store = BlockStore.open(root)  # as a reader would
    # one query from each of STORE_QUERIES templates
    every = ctx["work"].queries
    queries = every[::max(len(every) // STORE_QUERIES, 1)][:STORE_QUERIES]
    scans = counted("store", lambda: [store.scan_query(q)
                                      for q in queries])
    rows = []
    for i, (q, scan) in enumerate(zip(queries, scans)):
        sel = np.flatnonzero(q.evaluate(records, schema))
        sel = sel[np.argsort(oracle_bids[sel], kind="stable")]
        routed = set(store.engine.route_query(q).tolist())
        require(set(np.unique(oracle_bids[sel]).tolist()) <= routed,
                f"query {i}: a matching row lies in a skipped block")
        require(np.array_equal(scan.rows, records[sel]),
                f"query {i}: scanned rows differ from the brute-force "
                f"filter")
        rows.append({"rows": int(scan.rows.shape[0]),
                     "blocks_read": scan.blocks_read,
                     "bytes_read": scan.bytes_read,
                     "rows_scanned": scan.rows_scanned,
                     "wall_ms": scan.wall_s * 1e3})
    launched = ctx["path_launches"]["store"]
    require(launched["query_intersect"] == len(queries),
            f"store scans: {launched}")
    log(f"block store: written in {write_s:.1f}s; scans {rows}")
    return {"write_s": write_s, "scans": rows, "launches": launched,
            "rows": int(buf.n_rows)}


def autotune_phase(ctx, counted) -> dict:
    """``autotune_fused`` on one batch, persisted to a store under build/;
    then whole-table ingests with the tuned geometry (looked up by the
    engine) and with the analytic plan, alternated: both equal the oracle,
    and their walls are printed side by side."""
    import torch

    from repro_torch.core.qdtree import FrozenQdTree
    from repro_torch.engine import LayoutEngine, autotune

    store = ROOT / "build" / "autotune_cuda.json"
    none = ROOT / "build" / "autotune_none.json"
    for path in (store, none):
        path.unlink(missing_ok=True)
    before = os.environ.get("REPRO_TORCH_AUTOTUNE_STORE")

    def use(path):
        os.environ["REPRO_TORCH_AUTOTUNE_STORE"] = str(path)

    try:
        use(store)
        eng = LayoutEngine(FrozenQdTree.from_arrays(ctx["untightened"]))
        out = counted("autotune", lambda: autotune.autotune_fused(
            eng.tree, ctx["slices"][0], engine=eng))
        for row in out["rows"]:
            log(f"autotune candidate {row}")
        chosen = autotune.LaunchConfig.from_dict(out["chosen"])
        require(autotune.lookup("cuda", autotune.geometry_key(eng.tree))
                == chosen, "the chosen geometry was not persisted")
        walls = {"tuned": [], "analytic": []}
        for rep_i in range(TUNED_REPS):
            for name, path in (("analytic", none), ("tuned", store)):
                use(path)
                e = LayoutEngine(FrozenQdTree.from_arrays(ctx["untightened"]))
                e.warm_ingest(ctx["sizes"])
                torch.cuda.synchronize()
                acc = e._backend(None).accumulator(e.tree, e.plans, e.device)
                require(acc.launch == (chosen.launch if name == "tuned"
                                       else None),
                        f"{name} ingest took geometry {acc.launch}")
                r = e.ingest(ctx["slices"])
                if rep_i == 0:
                    require(leaves_equal(e.tree, ctx["oracle_tree"]),
                            f"{name} geometry: tightened tree differs from "
                            f"the oracle's")
                walls[name].append(r.wall_s * 1e3)
        # the kernel alone with each geometry, on one batch
        use(store)
        x = ctx["slices"][0]
        tuned_acc = eng._backend(None).accumulator(eng.tree, eng.plans,
                                                   eng.device)
        use(none)
        plan_acc = eng._backend(None).accumulator(eng.tree, eng.plans,
                                                  eng.device)
        kernel_ms = {"tuned": time_ms(lambda: tuned_acc.fold(x), 20),
                     "analytic": time_ms(lambda: plan_acc.fold(x), 20)}
        analytic_plan = dict(zip(("kernel", "warps", "smem_bytes",
                                  "most_blocks"), plan_acc.acc._launch or ()))
    finally:
        if before is None:
            os.environ.pop("REPRO_TORCH_AUTOTUNE_STORE", None)
        else:
            os.environ["REPRO_TORCH_AUTOTUNE_STORE"] = before
    log(f"autotune: chose {chosen}; ingest ms {walls}; kernel {kernel_ms}")
    return {"geometry": out["geometry"], "rows": out["rows"],
            "chosen": out["chosen"], "analytic_plan": analytic_plan,
            "ingest_ms": {k: spread(v) for k, v in walls.items()},
            "fold_ms": kernel_ms,
            "launches": ctx["path_launches"]["autotune"]}


def baseline_phase(ctx, counted, layouts) -> dict:
    """The baselines' Eq. 1 over the sample on the card (``query_intersect``
    on their tightened descriptions, their own block ids' sizes) against
    the numpy backend's, exactly; one batch routed through each baseline
    tree (``route_descend``) against the numpy route; and the qd-tree's
    Eq. 1 over the same sample, for the comparison."""
    import torch

    from repro_torch.core.qdtree import FrozenQdTree
    from repro_torch.engine import LayoutEngine
    from repro_torch.engine import backends as be
    from repro_torch.engine import plan as tplan

    sample, wt = ctx["sample"], ctx["wt"]
    numpy_be = be.get_backend("numpy")
    out = {}

    def eq1(eng, sizes):
        hits, scanned = eng._backend(None).query_intersect(
            eng.tree, eng.plans, wt, eng.device)
        return hits, scanned, int((hits * sizes[:, None]).sum())

    for name, (arrays, bids, build_s) in layouts.items():
        tree = FrozenQdTree.from_arrays(arrays)
        sizes = np.bincount(bids, minlength=tree.n_leaves).astype(np.int64)
        tree.block_sizes = sizes
        eng = LayoutEngine(tree)
        batch = sample[:BASELINE_ROUTE_ROWS]
        hits, scanned, total, routed = counted(
            f"baseline_{name}", lambda: (*eq1(eng, sizes), eng.route(
                torch.from_numpy(batch).to(ctx["dev"]))))
        n_hits, n_scanned = numpy_be.query_intersect(
            tree, tplan.PlanCache(), wt, ctx["dev"])
        require(np.array_equal(hits, n_hits)
                and np.array_equal(scanned, n_scanned),
                f"{name} layout: Eq. 1 on the card differs from numpy")
        require(np.array_equal(routed, tree.route(batch)),
                f"{name} layout: route differs from the numpy route")
        out[name] = {
            "blocks": tree.n_leaves, "depth": tree.depth,
            "scanned_fraction": total / (sample.shape[0] * wt.n_queries),
            "build_s": build_s,
            "launches": ctx["path_launches"][f"baseline_{name}"],
        }
    qd = LayoutEngine(FrozenQdTree.from_arrays(ctx["untightened"]))
    st = counted("baseline_qdtree", lambda: qd.skip_stats(sample, ctx["work"]))
    want = numpy_be.query_intersect(qd.tree, tplan.PlanCache(), wt,
                                    ctx["dev"])
    require(np.array_equal(st.query_hits, want[0])
            and np.array_equal(st.conj_scanned, want[1]),
            "qd-tree on the sample: Eq. 1 on the card differs from numpy")
    out["qdtree"] = {"blocks": qd.tree.n_leaves,
                     "scanned_fraction": st.scanned_fraction,
                     "launches": ctx["path_launches"]["baseline_qdtree"]}
    log(f"baselines on the {sample.shape[0]}-row sample: "
        f"{ {k: v['scanned_fraction'] for k, v in out.items()} }")
    return out


def d2h_copies(prof) -> list:
    """The device-to-host copies of a profiler trace: (bytes, ms) each.
    Bytes come from the trace's copy records; None where a record has no
    byte count."""
    import tempfile

    path = Path(tempfile.mkdtemp(prefix="qd-trace-")) / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()
    path.parent.rmdir()
    return [
        (ev.get("args", {}).get("bytes"), ev.get("dur", 0.0) / 1e3)
        for ev in events
        if ev.get("cat") == "gpu_memcpy" and "DtoH" in ev.get("name", "")
    ]


def env_split(sample, work, cuts, dev) -> tuple:
    """``TreeEnv``'s set-up in its parts, each on the host clock around
    work that ends in a sync (ms), before this slice and after it.
    Before: the check and the upload of the strided 1% sample (the upload
    gathers it), and the copy back of the matrix into pageable memory
    (``.cpu()``).  After: one gather of the sample, the check and upload
    of the contiguous copy, and the copy back into pinned memory
    (``env.to_host``).  Both: the operands' packing and upload, the kernel
    with its launch, ``workload.tensorize`` and the featurizer.  The two
    copies back each go into a fresh allocation, the forms alternated
    COPY_REPS times; one more pinned copy goes into a block the host
    allocator reuses.  ``before_ms`` and ``after_ms`` sum the parts, with
    the median copy of each form.  Returns the parts, and the uploaded
    sample and operands."""
    import torch

    from repro_torch.core.woodblock import env as wenv
    from repro_torch.core.woodblock.featurize import Featurizer
    from repro_torch.engine import plan as tplan
    from repro_torch.kernels import route_records as rk

    def part(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def upload(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    out = {}
    _, out["validate_strided_ms"] = part(
        lambda: work.schema.validate_records(sample))
    _, out["upload_strided_ms"] = part(lambda: upload(sample))
    flat, out["gather_ms"] = part(lambda: np.ascontiguousarray(sample))
    _, out["validate_ms"] = part(lambda: work.schema.validate_records(flat))
    rec, out["upload_ms"] = part(lambda: upload(flat))
    ops, out["upload_operands_ms"] = part(
        lambda: tplan.to_device(tplan.pack_cut_table(cuts), dev))
    mat, out["kernel_ms"] = part(lambda: rk.eval_cuts(rec, ops).view(
        torch.bool))
    forms = {"pageable": lambda: mat.cpu().numpy(),
             "pinned": lambda: wenv.to_host(mat)}
    copies, held = {"pageable": [], "pinned": []}, []
    for i in range(COPY_REPS):
        for form in ("pageable", "pinned")[::1 if i % 2 == 0 else -1]:
            h, t = part(forms[form])
            held.append(h)
            copies[form].append(t)
    require(all(np.array_equal(h, held[0]) for h in held[1:]),
            "the copies back differ")
    del held
    _, out["copy_pinned_reused_ms"] = part(forms["pinned"])
    _, out["tensorize_ms"] = part(lambda: work.tensorize(cuts))
    _, out["featurizer_ms"] = part(lambda: Featurizer(work.schema,
                                                      cuts.n_adv))
    out["copy_pageable_ms"] = copies["pageable"]
    out["copy_pinned_ms"] = copies["pinned"]
    both = (out["upload_operands_ms"] + out["kernel_ms"]
            + out["tensorize_ms"] + out["featurizer_ms"])
    out["before_ms"] = (both + out["validate_strided_ms"]
                        + out["upload_strided_ms"]
                        + float(np.median(copies["pageable"])))
    out["after_ms"] = (both + out["gather_ms"] + out["validate_ms"]
                       + out["upload_ms"]
                       + float(np.median(copies["pinned"])))
    return out, rec, ops


def woodblock_phase(ctx, counted) -> dict:
    """WOODBLOCK on the greedy tree's 1% sample: ``TreeEnv``'s cut matrix
    (one ``eval_cuts`` launch, equal to ``preds.eval_cuts`` on the host),
    the kernel at that shape against its plain version and its bound;
    ``build_layout(strategy="woodblock")`` within WOODBLOCK_BUDGET_S (its
    block ids equal the numpy route, its Eq. 1 hits the numpy hits); one
    ``ppo_update`` on the card against the same update on the CPU, in
    float64 (in float32 recorded only: see PPO_RTOL)."""
    import copy

    import torch

    from repro_torch.core import predicates as preds
    from repro_torch.core.woodblock import agent, ppo
    from repro_torch.core.woodblock.env import TreeEnv
    from repro_torch.engine import LayoutEngine
    from repro_torch.engine import backends as be
    from repro_torch.engine import plan as tplan
    from repro_torch.kernels import route_records as rk
    from repro_torch.service import build_layout

    dev, sample, work, cuts = (ctx["dev"], ctx["sample"], ctx["work"],
                               ctx["cuts"])
    t0 = time.perf_counter()
    env = counted("woodblock_env",
                  lambda: TreeEnv(sample, work, cuts, MIN_BLOCK, device=dev))
    env_s = time.perf_counter() - t0
    launched = ctx["path_launches"]["woodblock_env"]
    require(launched["eval_cuts"] == 1 and sum(launched.values()) == 1,
            f"TreeEnv launched {launched}; expected one eval_cuts")
    t0 = time.perf_counter()
    require(np.array_equal(env.cut_matrix, preds.eval_cuts(sample, cuts)),
            "TreeEnv's cut matrix differs from preds.eval_cuts")
    host_eval_s = time.perf_counter() - t0
    # the env's set-up in its parts; the kernel at the env's shape against
    # its plain version, timed, and alone in a trace
    split, rec, ops = env_split(sample, work, cuts, dev)
    err = max_abs_err([rk.eval_cuts(rec, ops)], [rk.eval_cuts_plain(rec,
                                                                    ops)])
    require(err == 0.0, f"eval_cuts differs from its plain version by {err}")
    ms, plain_ms = (time_ms(lambda: rk.eval_cuts(rec, ops), 20),
                    time_ms(lambda: rk.eval_cuts_plain(rec, ops), 3))
    trace = traced_kernel_sample(lambda: rk.eval_cuts(rec, ops), "eval_cuts",
                                 LAT_REPS)
    trace_ms = trace["ms"]
    m, d = sample.shape
    bound_ms, bound_by = bound(m * d * 4 + eval_table_bytes(ops)
                               + m * cuts.n_cuts, m * cuts.n_cuts)
    log(f"TreeEnv on {m} rows x {cuts.n_cuts} cuts: one eval_cuts launch, "
        f"equal to preds.eval_cuts; kernel {ms:.6f} ms, {trace_ms:.6f} in a "
        f"trace (bound {bound_ms:.6f} ms, {bound_by}), plain {plain_ms:.6f} "
        f"ms; set-up {env_s * 1e3:.3f} ms, split {split}")

    # the agent, timed where it syncs: a policy step per tree level (states
    # in, actions out) and each PPO update; the last update's inputs kept
    policy_ms, update_ms, last = [], [], {}
    orig_policy, orig_update = agent.Woodblock._policy_fn, ppo.ppo_update

    def timed_policy(self, states, legals):
        t = time.perf_counter()
        out = orig_policy(self, states, legals)
        policy_ms.append(((time.perf_counter() - t) * 1e3, len(states)))
        return out

    def timed_update(net, opt, batch, cfg):
        last.update(net=copy.deepcopy(net), opt=copy.deepcopy(opt),
                    batch=batch, cfg=cfg)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig_update(net, opt, batch, cfg)
        torch.cuda.synchronize()
        update_ms.append((time.perf_counter() - t) * 1e3)
        return out

    agent.Woodblock._policy_fn, ppo.ppo_update = timed_policy, timed_update
    try:
        build = counted("woodblock", lambda: build_layout(
            sample, work, strategy="woodblock", cuts=cuts,
            min_block=MIN_BLOCK, seed=SEED, device=dev,
            time_budget_s=WOODBLOCK_BUDGET_S))
    finally:
        agent.Woodblock._policy_fn, ppo.ppo_update = orig_policy, orig_update
    launched = ctx["path_launches"]["woodblock"]
    require(launched["eval_cuts"] == 1,
            f"build_woodblock launched {launched}; expected one eval_cuts")
    tree = build.tree
    require(np.array_equal(build.bids, tree.route(sample)),
            "woodblock layout: block ids differ from the numpy route")
    wt = work.tensorize(tree.cuts)
    n_hits, _ = be.get_backend("numpy").query_intersect(
        tree, tplan.PlanCache(), wt, dev)
    require(np.array_equal(LayoutEngine(tree, device=dev).query_hits(wt),
                           n_hits),
            "woodblock layout: Eq. 1 hits on the card differ from numpy")
    require(0.0 < build.scanned_fraction <= 1.0, "woodblock scanned")

    # one PPO update on the card against the CPU from the last update's
    # inputs, in float64 (held to PPO_*) and in float32 (recorded)
    def update_on(device, dtype):
        net = copy.deepcopy(last["net"]).to(device=device, dtype=dtype)
        opt = {s: {k: v.to(device=device, dtype=dtype)
                   for k, v in last["opt"][s].items()} for s in ("m", "v")}
        batch = {k: v.to(device=device, dtype=dtype)
                 if v.is_floating_point() else v.to(device)
                 for k, v in last["batch"].items()}
        net, opt, _ = ppo.ppo_update(net, dict(opt, t=last["opt"]["t"]),
                                     batch, last["cfg"])
        return [p.detach().cpu() for p in net.parameters()] + [
            opt[s][k].cpu() for s in ("m", "v") for k in sorted(opt[s])]

    def card_vs_cpu(dtype):
        err, ok = 0.0, True
        for a, b in zip(update_on(dev, dtype), update_on("cpu", dtype)):
            diff = (a - b).abs()
            err = max(err, float(diff.max()))
            ok &= bool((diff <= PPO_ATOL + PPO_RTOL * b.abs()).all())
        return err, ok

    timing_net, timing_opt = (copy.deepcopy(last["net"]),
                              copy.deepcopy(last["opt"]))
    ppo_err, ppo_ok = card_vs_cpu(torch.float64)
    require(ppo_ok, f"ppo_update on the card differs from the CPU's in "
                    f"float64 beyond rtol {PPO_RTOL}, atol {PPO_ATOL} (max "
                    f"{ppo_err})")
    ppo_err32, ppo_ok32 = card_vs_cpu(torch.float32)
    cfg = last["cfg"]
    ppo_card_ms = time_ms(lambda: ppo.ppo_update(
        timing_net, timing_opt, last["batch"], cfg), 10)
    n_ep = int(build.metrics["n_episodes"])
    levels = np.array([t for t, _ in policy_ms])
    out = {
        "sample_rows": m, "cuts": cuts.n_cuts, "env_s": env_s,
        "host_eval_cuts_s": host_eval_s,
        "eval_cuts": {"ms": ms, "trace_ms": trace_ms,
                      "trace_events": trace["events"], "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "max_abs_err": err},
        "env_split_ms": split,
        "budget_s": WOODBLOCK_BUDGET_S, "build_s": build.build_s,
        "episodes": n_ep, "episodes_per_s": n_ep / build.build_s,
        "policy_steps": len(policy_ms),
        "policy_step_ms": spread(levels.tolist()),
        "policy_step_nodes_mean": float(np.mean([n for _, n in policy_ms])),
        "ppo_updates": len(update_ms), "ppo_update_ms": spread(update_ms),
        "ppo_update_card_ms": ppo_card_ms,
        "ppo_batch_rows": int(last["batch"]["weight"].shape[0]),
        "ppo_card_vs_cpu_max_abs_err": ppo_err,
        "ppo_tolerance": {"rtol": PPO_RTOL, "atol": PPO_ATOL,
                          "dtype": "float64"},
        "ppo_card_vs_cpu_f32_max_abs_err": ppo_err32,
        "ppo_f32_within_tolerance": ppo_ok32,
        "leaves": tree.n_leaves, "depth": tree.depth,
        "best_scanned_sample": float(build.metrics["best_scanned_sample"]),
        "scanned_fraction": build.scanned_fraction,
        "greedy_scanned_sample": ctx["greedy_scanned_sample"],
        "launches": {"env": ctx["path_launches"]["woodblock_env"],
                     "build": launched},
    }
    log(f"woodblock: {n_ep} episodes in {build.build_s:.1f}s; best "
        f"{out['best_scanned_sample']:.6f} on the sample against greedy's "
        f"{ctx['greedy_scanned_sample']:.6f}; policy step "
        f"{out['policy_step_ms']} ms; ppo_update {ppo_card_ms:.3f} ms, card "
        f"vs CPU max {ppo_err:.3g} in float64, {ppo_err32:.3g} in float32")
    return out


def range_workload(schema, dim: int, n_queries: int, frac: float,
                   seed: int):
    """Random range queries over one column, each ``frac`` of its domain
    (``benchmarks/drift_rebuild.py``'s workloads)."""
    from repro_torch.core import predicates as preds
    from repro_torch.core import query as qry

    rng = np.random.default_rng(seed)
    dom = schema.doms[dim]
    width = max(int(dom * frac), 1)
    queries = []
    for _ in range(n_queries):
        lo = int(rng.integers(0, max(dom - width, 1)))
        queries.append(qry.Query.conjunction([
            qry.RangeAtom(dim, preds.OP_GE, lo),
            qry.RangeAtom(dim, preds.OP_LT, lo + width)]))
    return qry.Workload(schema, tuple(queries))


def oracle_tightened(tree, records: np.ndarray, bids: np.ndarray):
    """A copy of ``tree`` tightened by the numpy oracle on ``records``."""
    from repro_torch.core.qdtree import FrozenQdTree, IncrementalTightener

    out = FrozenQdTree.from_arrays(tree.to_arrays())
    t = IncrementalTightener(out)
    t.update(records, bids)
    t.apply()
    return out


def service_phase(ctx, counted) -> dict:
    """The layout lifecycle on the greedy layout (``LayoutService``).

    An observed ingest (the device probe) against an unobserved one: every
    batch's WindowStat equals the host probe's over the oracle's ids, the
    tree equals the oracle's, and a trace shows one accumulator copy back
    (the per-batch sums are 8 bytes each, the ids never come back), with
    every batch scored on the card.  ``LayoutService.ingest`` of the
    whole table in one call at the default batch: one ``fused_ingest`` a
    2^20-row batch, equal to the oracle.  Then
    ``benchmarks/drift_rebuild.py``'s scenario at the table's scale: the
    first half ingested under shipdate ranges, the second under
    extendedprice ranges, one batch a call through ``auto_rebuilder``
    (rebuilds inline, on a RESERVOIR-row reservoir); each call's block
    sizes and the last call of each generation's descriptions equal the
    numpy oracle's for the generation it ingested into, no rebuild
    failed, one accumulator copy back a call, no plan builds outside a swap but the per-call
    query-description plan.  A rebuild deployed after the shift recovers
    to within 1.2x a greedy build on a 1% sample of the second half.  A
    rebuild on a ``drift-rebuild`` thread under concurrent routing, a
    timed swap, rollback and release, each followed by route and
    route_queries against numpy; a tracker-driven k = 2 replica deploy
    whose cheapest routing equals the numpy backend's."""
    import threading
    from concurrent.futures import ThreadPoolExecutor as Pool
    from torch.profiler import ProfilerActivity, profile

    import torch

    from repro_torch.core.qdtree import FrozenQdTree
    from repro_torch.engine import LayoutEngine, WindowStat
    from repro_torch.engine import backends as be
    from repro_torch.engine.engine import ObservationProbe
    from repro_torch.engine import plan as tplan
    from repro_torch.kernels import fused_ingest as fk
    from repro_torch.service import (DriftConfig, IngestOptions, LayoutBuild,
                                     LayoutService, RebuildPolicy,
                                     build_layout)

    dev, records, rec_dev = ctx["dev"], ctx["records"], ctx["rec_dev"]
    slices, sizes, n_rows = ctx["slices"], ctx["sizes"], ctx["n_rows"]
    oracle_bids, untightened = ctx["oracle_bids"], ctx["untightened"]
    schema, sample = ctx["work"].schema, ctx["sample"]
    work_a = range_workload(schema, SHIPDATE, DRIFT_QUERIES, DRIFT_FRAC,
                            SEED + 1)
    work_b = range_workload(schema, EXTENDEDPRICE, DRIFT_QUERIES,
                            DRIFT_FRAC, SEED + 2)
    n_b = len(slices)
    out = {}

    # -- the device probe against the host probe; observed vs unobserved --
    def fresh():
        eng = LayoutEngine(FrozenQdTree.from_arrays(untightened), device=dev)
        eng.warm_ingest(sizes)
        torch.cuda.synchronize()
        return eng

    eng = fresh()
    probe = eng.observation_probe(work_a)
    require(probe.on_device is not None and probe.on_device.device == dev
            and probe.on_device.dtype == torch.int64,
            "an engine on the card keeps the probe's counts on the card")
    seen = []
    counted("service_observe", lambda: eng.ingest(
        slices, observe=probe, on_observation=seen.append))
    want = [WindowStat(int(probe.per_leaf[oracle_bids[s:s + BATCH]].sum()),
                       min(BATCH, n_rows - s) * probe.n_queries,
                       min(BATCH, n_rows - s))
            for s in range(0, n_rows, BATCH)]
    require(seen == want, "device-probe observations differ from the host "
                          "probe's over the oracle's ids")
    require(leaves_equal(eng.tree, ctx["oracle_tree"]),
            "observed ingest: tightened tree differs from the oracle's")
    walls = {"observed": [], "unobserved": []}
    for _ in range(OBSERVE_REPS):
        walls["unobserved"].append(fresh().ingest(slices).wall_s * 1e3)
        walls["observed"].append(
            fresh().ingest(slices, observe=probe).wall_s * 1e3)
    traced_eng = fresh()
    device_sums = []
    orig_observe = ObservationProbe.observe

    def counting_observe(self, bids):
        device_sums.append(isinstance(bids, torch.Tensor)
                           and bids.device == dev)
        return orig_observe(self, bids)

    ObservationProbe.observe = counting_observe
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced_eng.ingest(slices, observe=probe)
    finally:
        ObservationProbe.observe = orig_observe
    copies = d2h_copies(prof)
    known = [b for b, _ in copies if b is not None]
    require(len(known) == len(copies), f"copies without byte counts: "
                                       f"{copies[:4]}")
    # each batch is scored once, on the card, from ids that stay there
    require(len(device_sums) == n_b and all(device_sums),
            f"observed ingest scored {len(device_sums)} batches "
            f"({sum(device_sums)} on the card) for {n_b} batches")
    # the accumulator once; every other copy a batch's 8-byte sum (the
    # block ids never come back). The trace may drop some of the small
    # copies (it showed 15 for 16 batches once), so their number is held
    # by the count of device sums above, not by the trace
    big = [b for b in known if b > 8]
    require(len(big) == 1 and len(known) <= n_b + 1,
            f"observed ingest copied back {sorted(known)[-4:]} ... "
            f"({len(known)} copies for {n_b} batches); expected one "
            f"accumulator copy and an 8-byte sum a batch")
    out["observe"] = {
        "wall_ms": {k: spread(v) for k, v in walls.items()},
        "d2h_copies": len(known), "device_sums": len(device_sums),
        "accumulator_bytes": big[0],
        "launches": ctx["path_launches"]["service_observe"],
    }
    log(f"observed ingest: per-batch stats equal the host probe's; walls "
        f"{out['observe']['wall_ms']} ms; copies back {len(known)} "
        f"(accumulator {big[0]} B)")

    # -- the service's ingest entry point on the whole table in one call, at
    # IngestOptions' default batch on the card (one fused_ingest a batch) --
    whole = LayoutService(FrozenQdTree.from_arrays(untightened), device=dev)
    default_batch = whole.ingest_batch(IngestOptions())
    require(default_batch == BATCH,
            f"the service's default batch on the card is {default_batch}")
    whole.engine.warm_ingest(sizes)
    seen = []
    rep = counted("service_ingest", lambda: whole.ingest(
        rec_dev, IngestOptions(observe=probe), on_observation=seen.append))
    launched = ctx["path_launches"]["service_ingest"]
    require(rep.n_batches == n_b and launched["fused_ingest_shared"] == n_b
            and sum(launched.values()) == n_b,
            f"svc.ingest of {n_rows} rows: {rep.n_batches} batches, "
            f"launches {launched}")
    require(seen == want and leaves_equal(whole.tree, ctx["oracle_tree"]),
            "svc.ingest at the default batch differs from the oracle")
    out["ingest_default"] = {"batch": default_batch, "batches": rep.n_batches,
                             "wall_ms": rep.wall_s * 1e3,
                             "launches": launched}
    log(f"svc.ingest of the whole table at the default batch "
        f"{default_batch}: {rep.n_batches} fused_ingest launches, "
        f"{rep.wall_s * 1e3:.3f} ms")
    del whole

    # -- the drift scenario ----------------------------------------------
    boot = FrozenQdTree.from_arrays(untightened)
    boot_bids = boot.route(sample)
    boot.tighten(sample, boot_bids)
    svc = LayoutService(LayoutBuild(
        tree=boot, bids=boot_bids, strategy="greedy", build_s=0.0,
        metrics={"scanned_fraction": float("nan"),
                 "n_leaves": boot.n_leaves},
        provenance={"strategy": "greedy"}), device=dev)
    gen0 = svc.generation
    rebuilder = svc.auto_rebuilder(RebuildPolicy(
        workload=work_a,
        drift=DriftConfig(window=8, min_fill=4, abs_threshold=0.5,
                          rel_degradation=1.0, hysteresis=2, cooldown=8),
        reservoir_capacity=RESERVOIR, executor="sync",
        rebuild_kw=dict(min_block=MIN_BLOCK, seed=SEED)))

    def warm(engine):
        engine.warm_ingest(sizes)
        for w in (work_a, work_b):
            engine.query_hits(w)
        torch.cuda.synchronize()

    warm(svc.engine)
    partials = []
    orig_partial = fk.IngestAccumulator.partial

    def counting_partial(self, tree):
        partials.append(1)
        return orig_partial(self, tree)

    shift = n_b // 2
    calls = []

    def drift():
        for i, b in enumerate(slices):
            if i == shift:
                rebuilder.set_workload(work_b)  # the queries drift, silently
            versions0 = {g: tplan.desc_version(svc.version(g).tree)
                         for g in svc.versions()}
            live0, builds0 = svc.generation, tplan.build_counts()
            events0 = len(rebuilder.events)
            del partials[:]
            rep = svc.ingest([b], IngestOptions(monitor=rebuilder))
            torch.cuda.synchronize()
            into = [g for g, v in versions0.items()
                    if tplan.desc_version(svc.version(g).tree) != v]
            require(len(into) == 1, f"call {i}: ingested into {into}")
            swapped = svc.generation != live0
            calls.append({"batch": i, "gen": into[0], "swapped": swapped,
                          "rebuilt": len(rebuilder.events) > events0,
                          "builds": tplan.build_delta(builds0,
                                                      tplan.build_counts()),
                          "copies": len(partials), "rep": rep})
            if swapped:
                warm(svc.engine)  # the new generation's plans: swap cost

    fk.IngestAccumulator.partial = counting_partial
    try:
        counted("service_drift", drift)
    finally:
        fk.IngestAccumulator.partial = orig_partial
    failed = [e.error for e in rebuilder.events if e.error]
    require(not failed, f"drift rebuilds failed: {failed}")
    deployed = [e for e in rebuilder.events if e.deployed]
    require(len(deployed) >= 1 and svc.generation != gen0,
            "the workload shift did not deploy a rebuild")
    require(all(e.observation > 0 for e in deployed)
            and min(c["batch"] for c in calls if c["swapped"]) >= shift,
            "a rebuild deployed before the shift")
    # each call against the numpy oracle of the generation it ingested into
    last_of = {}
    for c in calls:
        s = c["batch"] * BATCH
        rows = records[s:s + BATCH]
        tree = svc.version(c["gen"]).tree
        bids = (oracle_bids[s:s + BATCH] if c["gen"] == gen0
                else tree.route(rows))
        require(np.array_equal(c["rep"].block_sizes,
                               np.bincount(bids, minlength=tree.n_leaves)),
                f"call {c['batch']}: block sizes differ from the oracle's")
        # a call that ran a rebuild also folded the rebuild's build records
        require(c["copies"] == 1 or (c["rebuilt"] and c["copies"] > 1),
                f"call {c['batch']}: {c['copies']} accumulator copies back")
        other = {k: v for k, v in c["builds"].items() if k != "query:torch"}
        require(c["swapped"] or (not other
                                 and c["builds"].get("query:torch", 0) <= 1),
                f"call {c['batch']}: plans built outside a swap: "
                f"{c['builds']}")
        last_of[c["gen"]] = (c["batch"], rows, bids)
    for g, (i, rows, bids) in last_of.items():
        tree = svc.version(g).tree
        want = oracle_tightened(tree, rows, bids)
        require(all(np.array_equal(getattr(want, f), getattr(tree, f))
                    for f in ("leaf_lo", "leaf_hi", "leaf_cat", "leaf_adv")),
                f"generation {g}: descriptions after call {i} differ from "
                f"the numpy oracle's")
    phase_b, phase_b_dev = records[shift * BATCH:], rec_dev[shift * BATCH:]
    recovered = svc.skip_stats(phase_b_dev, work_b, tighten=False)
    oracle_build = build_layout(phase_b[::SAMPLE_EVERY], work_b,
                                min_block=MIN_BLOCK, seed=SEED, device=dev,
                                plan_cache=svc.plans)
    oracle = LayoutEngine(oracle_build.tree, device=dev,
                          plan_cache=svc.plans).skip_stats(
        phase_b_dev, work_b, tighten=False)
    ratio = recovered.scanned_fraction / oracle.scanned_fraction
    require(ratio <= ORACLE_RATIO,
            f"recovered {recovered.scanned_fraction:.6f} is {ratio:.3f}x the "
            f"greedy oracle's {oracle.scanned_fraction:.6f}")
    rates = [c["rep"].observation.scanned_fraction
             if c["rep"].observation is not None else None for c in calls]
    ev = deployed[0]
    out["drift"] = {
        "calls": len(calls), "shift_batch": shift,
        "swap_batches": [c["batch"] for c in calls if c["swapped"]],
        "rebuilds_deployed": len(deployed),
        "events": [{"observation": e.observation, "deployed": e.deployed,
                    "skipped": e.skipped, "reason": e.decision.reason,
                    "error": e.error, "wall_s": e.wall_s}
                   for e in rebuilder.events],
        "rebuild_s": ev.wall_s, "rebuild_build_s": ev.report.build_s,
        "rebuild_score_s": ev.report.score_s,
        "rebuild_leaves": ev.report.build.n_leaves,
        "batch_rates": rates,
        "pre_shift_rate_max": max(r for r in rates[:shift] if r is not None),
        "post_shift_rate_peak": max(r for r in rates[shift:]
                                    if r is not None),
        "recovered_scanned": recovered.scanned_fraction,
        "oracle_scanned": oracle.scanned_fraction,
        "oracle_ratio": ratio, "oracle_leaves": oracle_build.tree.n_leaves,
        "query_plan_builds": sum(c["builds"].get("query:torch", 0)
                                 for c in calls if not c["swapped"]),
        "launches": ctx["path_launches"]["service_drift"],
    }
    rebuilder.close()
    log(f"drift: rebuilds deployed at batches "
        f"{out['drift']['swap_batches']} (shift at {shift}); recovered "
        f"{recovered.scanned_fraction:.6f} against the greedy oracle's "
        f"{oracle.scanned_fraction:.6f} ({ratio:.3f}x)")

    # -- hot swap from another thread under concurrent routing; timed swap,
    # rollback and release, each checked against numpy ------------------
    check_dev = rec_dev[-CHECK_ROWS:]
    check = records[-CHECK_ROWS:]
    numpy_route = {}

    def routed_like_numpy(v) -> bool:
        if v.generation not in numpy_route:
            numpy_route[v.generation] = v.tree.route(check)
        return np.array_equal(v.engine.route(check_dev),
                              numpy_route[v.generation])

    def same_as_numpy(what):
        v = svc.live_version()
        require(np.array_equal(svc.route(check_dev), v.tree.route(check)),
                f"after {what}: route differs from numpy")
        for w in (work_a, work_b):
            for got, want in zip(svc.route_queries(w),
                                 svc.route_queries(w, backend="numpy")):
                require(np.array_equal(got, want),
                        f"after {what}: route_queries differs from numpy")

    same_as_numpy("the drift rebuild's swap")
    reservoir = rebuilder.reservoir.snapshot()
    before = svc.generation
    stop, routes, bad = threading.Event(), [0], []

    def router():
        while not stop.is_set():
            v = svc.live_version()
            if not routed_like_numpy(v):
                bad.append(v.generation)
            routes[0] += 1
            time.sleep(0.001)  # leave the rebuild the GIL

    def lifecycle():
        with Pool(1, thread_name_prefix="drift-rebuild") as pool:
            fut = pool.submit(svc.rebuild, reservoir, work_b, swap="always",
                              min_block=MIN_BLOCK // 2, seed=SEED)
            r = threading.Thread(target=router)
            r.start()
            try:
                # svc.rebuild called directly: a failure raises here (only
                # AutoRebuilder turns errors into events)
                bg = fut.result()
            finally:
                stop.set()
                r.join()
        require(bg.swapped and svc.generation != before and not bad,
                f"background rebuild: swapped {bg.swapped}, generations "
                f"routed unlike numpy {bad}")
        same_as_numpy("a rebuild on another thread")
        times = {}
        t = time.perf_counter()
        g_swap = svc.swap(oracle_build)
        times["swap_ms"] = (time.perf_counter() - t) * 1e3
        same_as_numpy("swap")
        t = time.perf_counter()
        g_back = svc.rollback()
        times["rollback_ms"] = (time.perf_counter() - t) * 1e3
        require(g_back == bg.new_generation, f"rollback went to {g_back}")
        same_as_numpy("rollback")
        t = time.perf_counter()
        times["release_evicted"] = svc.release(g_swap)
        times["release_ms"] = (time.perf_counter() - t) * 1e3
        same_as_numpy("release")
        return bg, times

    bg, times = counted("service_swap", lifecycle)
    out["lifecycle"] = {
        "background_rebuild_s": bg.build_s + bg.score_s,
        "routes_during_rebuild": routes[0], **times,
        "launches": ctx["path_launches"]["service_swap"],
    }
    log(f"lifecycle: {routes[0]} routes during a background rebuild, all "
        f"like numpy; {times}")

    # -- replicas from the tracker ----------------------------------------
    from repro_torch.core import query as qry

    mix = qry.Workload(schema, work_a.queries + work_b.queries)
    tracker = svc.workload_tracker()
    for _ in range(REPLICA_ROUNDS):
        svc.serve(work_a, tracker=tracker)
        svc.serve(work_b, tracker=tracker)
    top = 2 * DRIFT_QUERIES  # every served signature
    one = svc.rebuild_replicas(sample, k=1, tracker=tracker, top_k=top,
                               swap="never", min_block=MIN_BLOCK, seed=SEED)
    rep = counted("service_replicas", lambda: svc.rebuild_replicas(
        sample, k=2, tracker=tracker, top_k=top, swap="always",
        min_block=MIN_BLOCK, seed=SEED))
    rset = svc.live_replica_set()
    require(rep.swapped and rset.k == len(rep.builds) == 2,
            f"the replica set was not deployed: {rep.swapped}, "
            f"{len(rep.builds)} builds")
    got = svc.route_queries_cheapest(mix)
    want = svc.route_queries_cheapest(mix, backend="numpy")
    for q, (a, b) in enumerate(zip(got, want)):
        require(a.replica_id == b.replica_id and a.cost == b.cost
                and np.array_equal(a.bids, b.bids),
                f"replicas: query {q}'s cheapest route differs from numpy's")
    # Eq. 1 on the sample over the tracked mix: one layout for the whole
    # mix (1x storage) against cheapest-replica routing over two (2x)
    scanned = {"1x": one.candidate_scanned, "2x": rep.candidate_scanned}
    out["replicas"] = {
        "k": rset.k, "clusters": [len(c) for c in rep.clusters],
        "leaves": [v.tree.n_leaves for v in rset.versions],
        "build_s": rep.build_s, "score_s": rep.score_s,
        "live_scanned": rep.live_scanned, "scanned": scanned,
        "chosen_replicas": np.bincount([r.replica_id for r in got],
                                       minlength=rset.k).tolist(),
        "launches": ctx["path_launches"]["service_replicas"],
    }
    log(f"replicas: k={rset.k}, cheapest routing equal to numpy's; the "
        f"tracked mix on the sample scans {scanned}")
    return out


def workload_keys(plans) -> set:
    """The plan cache's standing workload operands."""
    from repro_torch.engine.plan import PlanKey

    with plans._lock:
        return {k for k in plans._plans
                if isinstance(k, PlanKey) and k.opts[:1] == ("workload",)}


def serve_phase(ctx, counted) -> dict:
    """The serving tier (``QueryServer`` over ``LayoutService``) on the
    whole table's tightened greedy layout, the 150-query workload as the
    templates of a Zipf(s = 1.1) mix, as ``benchmarks/serving.py`` runs it.

    (a) SERVE_ROUNDS sync ``serve_batch`` rounds of SERVE_BATCH queries,
    a greedy rebuild on the 1% sample under the service phase's shifted
    workload swapped in at round SERVE_SWAP_AT and warmed: every response
    equals the numpy route of its query on its generation's tree, no stale
    response, no plan built outside the swap's window, one
    ``query_intersect`` launch an engine dispatch; the hit path's ms
    against one engine dispatch of the same batch.  (b) SERVE_CLIENTS
    client threads × SERVE_PER_CLIENT queries through the async
    dispatcher, the main thread swapping in another sample-built layout
    (its plan warmed first) once SERVE_SWAP_AFTER queries were served: qps
    and p50/p99, no stale response, every response equal to numpy, no plan
    built at all.  The standing workloads' operands survive both."""
    import threading

    import torch

    from repro_torch.core import query as qry
    from repro_torch.core.qdtree import FrozenQdTree
    from repro_torch.engine import LayoutEngine
    from repro_torch.engine import plan as tplan
    from repro_torch.kernels import _build
    from repro_torch.launch.serve import zipf_mix
    from repro_torch.serve import QueryServer, ServeConfig
    from repro_torch.service import LayoutService, build_layout

    dev, work, sample = ctx["dev"], ctx["work"], ctx["sample"]
    schema = work.schema
    svc = LayoutService(FrozenQdTree.from_arrays(ctx["tree"].to_arrays()),
                        device=dev)
    # the standing workloads: the declared one, the drift workloads' probe
    work_b = range_workload(schema, EXTENDEDPRICE, DRIFT_QUERIES,
                            DRIFT_FRAC, SEED + 2)
    work_c = range_workload(schema, EXTENDEDPRICE, DRIFT_QUERIES,
                            DRIFT_FRAC, SEED + 3)
    svc.query_hits(work)
    svc.engine.observation_probe(range_workload(
        schema, SHIPDATE, DRIFT_QUERIES, DRIFT_FRAC, SEED + 1))
    torch.cuda.synchronize()
    index = {id(q): i for i, q in enumerate(work.queries)}
    numpy_lists = {}

    def expected(gen):
        """Each template's numpy route on generation ``gen``'s tree; the
        card's ``route_queries`` of the templates equals it."""
        if gen not in numpy_lists:
            v = svc.version(gen)
            want = LayoutEngine(v.tree, backend="numpy",
                                device="cpu").route_queries(work)
            got = v.engine.route_queries(work, transient=True)
            require(all(np.array_equal(a, b) for a, b in zip(got, want)),
                    f"generation {gen}: route_queries on the card differs "
                    f"from numpy")
            numpy_lists[gen] = want
        return numpy_lists[gen]

    def same_as_numpy(pairs, what):
        for q, r in pairs:
            require(np.array_equal(r.bids,
                                   expected(r.generation)[index[id(q)]]),
                    f"{what}: a response differs from the numpy route on "
                    f"generation {r.generation}")

    standing = workload_keys(svc.plans)
    require(len(standing) == 2, f"standing workloads {len(standing)}")
    config = ServeConfig(max_batch=SERVE_BATCH, max_delay_s=0.001,
                         cache_capacity=4096)

    # -- (a) deterministic rounds -----------------------------------------
    server = QueryServer(svc, config, tracker=svc.workload_tracker())
    server.warm(work)
    mix = zipf_mix(work, SERVE_ROUNDS * SERVE_BATCH, SERVE_ZIPF, SEED + 2)
    pairs, outside, swap = [], {}, {}

    def rounds():
        for r in range(SERVE_ROUNDS):
            if r == SERVE_SWAP_AT:
                b0 = tplan.build_counts()
                t = time.perf_counter()
                rep = svc.rebuild(sample, work_b, swap="always",
                                  min_block=MIN_BLOCK, seed=SEED)
                server.warm(work)
                torch.cuda.synchronize()
                swap.update(rebuild_s=rep.build_s + rep.score_s,
                            swap_and_warm_s=time.perf_counter() - t,
                            generation=rep.new_generation,
                            leaves=rep.build.n_leaves,
                            builds=tplan.build_delta(b0, tplan.build_counts()))
            qs = mix[r * SERVE_BATCH:(r + 1) * SERVE_BATCH]
            b0 = tplan.build_counts()
            n0 = _build.launch_counts()["query_intersect"]
            d0 = server.counters.engine_dispatches
            res = server.serve_batch(qs)
            launched = _build.launch_counts()["query_intersect"] - n0
            require(launched == server.counters.engine_dispatches - d0,
                    f"round {r}: {launched} query_intersect launches for "
                    f"{server.counters.engine_dispatches - d0} engine "
                    f"dispatches")
            delta = tplan.build_delta(b0, tplan.build_counts())
            if delta:
                outside[r] = delta
            pairs.extend(zip(qs, res))

    counted("serve_rounds", rounds)
    det = server.stats()
    require(not outside, f"plans built while serving: {outside}")
    require(det["counters"]["stale_responses"] == 0,
            f"{det['counters']['stale_responses']} stale responses")
    require(swap.get("generation") == svc.generation,
            "the rebuild at the swap round was not deployed")
    same_as_numpy(pairs, "sync rounds")
    # the hit path against one engine dispatch of the same batch
    hot = mix[:SERVE_BATCH]
    server.serve_batch(hot)
    require(all(r.cached for r in server.serve_batch(hot)),
            "the hot batch is not all cache hits")
    hit_ms = host_ms(lambda: server.serve_batch(hot), HIT_REPS)
    live = svc.live_version()

    def engine_dispatch():
        wl = qry.Workload(schema, tuple(hot))
        return live.engine.route_queries(wl.tensorize(live.tree.cuts),
                                         transient=True)

    dispatch_ms = host_ms(engine_dispatch, HIT_REPS)
    server.stop()
    out = {
        "rounds": SERVE_ROUNDS, "batch": SERVE_BATCH,
        "swap_round": SERVE_SWAP_AT, "swap": swap,
        "queries_served": det["counters"]["queries_served"],
        "queries_cached": det["counters"]["queries_cached"],
        "queries_routed": det["counters"]["queries_routed"],
        "dispatches": det["counters"]["dispatches"],
        "engine_dispatches": det["counters"]["engine_dispatches"],
        "hit_rate": det["cache"]["hit_rate"],
        "invalidated": det["cache"]["invalidated"],
        "stale_puts": det["cache"]["stale_puts"],
        "stale_responses": det["counters"]["stale_responses"],
        "builds_outside_swap": outside,
        "launches": ctx["path_launches"]["serve_rounds"],
        "hit_path_ms": hit_ms, "engine_dispatch_ms": dispatch_ms,
        "hit_speedup": dispatch_ms["median"] / hit_ms["median"],
    }
    log(f"serve rounds: {out['queries_served']} queries, hit rate "
        f"{out['hit_rate']:.4f}, {out['engine_dispatches']} engine "
        f"dispatches, swap {swap}; hit path {hit_ms['median']:.4f} ms "
        f"against an engine dispatch {dispatch_ms['median']:.4f} ms")

    # -- (b) closed loop through the async dispatcher, a hot swap from the
    # main thread under live traffic ---------------------------------------
    cand = build_layout(sample, work_c, min_block=MIN_BLOCK, seed=SEED + 3,
                        device=dev, plan_cache=svc.plans)
    LayoutEngine(cand.tree, device=dev, plan_cache=svc.plans).query_hits(
        work, transient=True)  # its query plan: swap cost, paid here
    torch.cuda.synchronize()
    server = QueryServer(svc, config, tracker=svc.workload_tracker())
    server.start()
    server.warm(work)
    cl_pairs, errors, lock = [], [], threading.Lock()
    p = np.arange(1, len(work) + 1, dtype=np.float64) ** -SERVE_ZIPF
    p /= p.sum()

    def client(tid):
        rng = np.random.default_rng(SEED + 100 + tid)
        mine = []
        try:
            for _ in range(SERVE_PER_CLIENT):
                q = work.queries[int(rng.choice(len(work), p=p))]
                mine.append((q, server.serve(q, tenant=f"t{tid}",
                                             timeout=60.0)))
        except BaseException as e:  # raised after the join
            errors.append(e)
        with lock:
            cl_pairs.extend(mine)

    def closed_loop():
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        b0 = tplan.build_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        while server.counters.queries_served < SERVE_SWAP_AFTER and any(
                t.is_alive() for t in threads):
            time.sleep(0.0005)
        served_at_swap = server.counters.queries_served
        gen = svc.swap(cand)
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        return (wall, gen, served_at_swap,
                tplan.build_delta(b0, tplan.build_counts()))

    wall, gen, served_at_swap, builds = counted("serve_closed_loop",
                                                closed_loop)
    server.stop()
    if errors:
        raise errors[0]
    cl = server.stats()
    n = len(cl_pairs)
    require(n == SERVE_CLIENTS * SERVE_PER_CLIENT, f"{n} queries served")
    require(cl["counters"]["stale_responses"] == 0,
            f"closed loop: {cl['counters']['stale_responses']} stale")
    require(not builds, f"closed loop built plans: {builds}")
    require(served_at_swap < n, "the swap came after the traffic")
    same_as_numpy(cl_pairs, "closed loop")
    require(workload_keys(svc.plans) >= standing,
            "serving evicted a standing workload's operands")
    launched = ctx["path_launches"]["serve_closed_loop"]
    require(launched["query_intersect"] == cl["counters"]["engine_dispatches"]
            and sum(launched.values()) == launched["query_intersect"],
            f"closed loop: launches {launched} for "
            f"{cl['counters']['engine_dispatches']} engine dispatches")
    out["closed_loop"] = {
        "clients": SERVE_CLIENTS, "per_client": SERVE_PER_CLIENT,
        "queries": n, "wall_s": wall, "qps": n / wall,
        "p50_ms": cl["latency"]["p50_ms"], "p99_ms": cl["latency"]["p99_ms"],
        "mean_ms": cl["latency"]["mean_ms"],
        "hit_rate": cl["cache"]["hit_rate"],
        "dispatches": cl["counters"]["dispatches"],
        "engine_dispatches": cl["counters"]["engine_dispatches"],
        "stale_responses": cl["counters"]["stale_responses"],
        "uncached_dispatches": cl["counters"]["uncached_dispatches"],
        "swap_generation": gen, "served_at_swap": served_at_swap,
        "builds": builds, "admission": cl["admission"],
        "launches": launched,
    }
    out["standing_workloads_kept"] = len(standing)
    log(f"serve closed loop: {n} queries in {wall:.3f} s "
        f"({n / wall:.1f} qps), p50 {cl['latency']['p50_ms']:.4f} ms, p99 "
        f"{cl['latency']['p99_ms']:.4f} ms, swap to gen {gen} after "
        f"{served_at_swap} served; hit rate {cl['cache']['hit_rate']:.4f}")
    return out


def pipeline_phase(ctx, counted, store_root) -> dict:
    """``QdTreePipeline`` over the prefix's block store, curated by
    PIPELINE_QUERIES workload queries: each pipeline reads only the blocks
    its query's route names, and the rows behind every batch, in the
    scheduler's block order, equal a brute-force ``Query.evaluate`` of the
    prefix."""
    from repro_torch.data import pipeline as pl
    from repro_torch.data.blocks import BlockStore

    records, oracle_bids = ctx["records"], ctx["oracle_bids"]
    work = ctx["work"]
    schema = work.schema
    store = BlockStore.open(store_root)
    # the most selective templates expected to fill PIPELINE_MIN_ROWS rows
    # of the prefix (selectivity read off the 1% sample): tokenizing is
    # host code, a row at a time
    sample = ctx["sample"]
    scale = ctx["n_rows"] / sample.shape[0]
    per_q = [int(q.evaluate(sample, schema).sum()) for q in work.queries]
    order = sorted((c, i) for i, c in enumerate(per_q)
                   if c * scale >= PIPELINE_MIN_ROWS)
    chosen = [work.queries[i] for _, i in order[:PIPELINE_QUERIES]]
    require(len(chosen) == PIPELINE_QUERIES, "too few curation queries")
    spied = []  # (rows, tokens) of each block the pipelines tokenized
    orig = pl.records_to_tokens

    def spy(rows, *a, **k):
        toks = orig(rows, *a, **k)
        spied.append((rows, toks))
        return toks

    def run_all():
        outs = []
        for q in chosen:
            cfg = pl.PipelineConfig(batch_size=PIPELINE_BATCH,
                                    seq_len=PIPELINE_SEQ, vocab=PIPELINE_VOCAB,
                                    curation_query=q, seed=SEED)
            t0 = time.perf_counter()
            pipe = pl.QdTreePipeline(store, cfg)
            start = len(spied)
            batches = list(pipe)
            outs.append((q, pipe, batches, spied[start:],
                         time.perf_counter() - t0))
        return outs

    pl.records_to_tokens = spy
    try:
        outs = counted("pipeline", run_all)
    finally:
        pl.records_to_tokens = orig
    rows_out = []
    for q, pipe, batches, seen, wall in outs:
        # the brute-force rows, block by block in the scheduler's order
        idx = np.flatnonzero(q.evaluate(records, schema))
        idx = idx[np.argsort(oracle_bids[idx], kind="stable")]
        starts = np.searchsorted(oracle_bids[idx],
                                 np.arange(store.tree.n_leaves + 1))
        sched = pl.ElasticBlockScheduler(pipe.block_ids, seed=SEED)
        blocks = []
        while (b := sched.next_block(0)) is not None:
            blocks.append(b)
        require(sorted(blocks) == sorted(pipe.block_ids)
                and len(blocks) <= store.tree.n_leaves,
                "the pipeline's blocks")
        require(set(np.unique(oracle_bids[idx]).tolist()) <= set(blocks),
                "a matching row lies in a block the curation skipped")
        want = records[np.concatenate(
            [idx[starts[b]:starts[b + 1]] for b in blocks])]
        got = (np.concatenate([r for r, _ in seen]) if seen
               else want[:0])
        require(np.array_equal(got, want),
                "the pipeline's rows differ from the brute-force filter")
        n_full = want.shape[0] // PIPELINE_BATCH
        require(len(batches) == n_full,
                f"{len(batches)} batches for {want.shape[0]} rows")
        if n_full:
            toks = np.concatenate([t for _, t in seen])[
                :n_full * PIPELINE_BATCH]
            require(np.array_equal(np.concatenate([x for x, _ in batches]),
                                   toks[:, :-1])
                    and np.array_equal(
                        np.concatenate([y for _, y in batches]),
                        toks[:, 1:]),
                    "the batches differ from their rows' tokens")
        rows_out.append({
            "rows": int(want.shape[0]), "batches": len(batches),
            "blocks_read": len(blocks),
            "blocks_skipped": pipe.blocks_skipped,
            "wall_s": wall,
            "records_per_s": want.shape[0] / wall if wall else 0.0,
        })
    launched = ctx["path_launches"]["pipeline"]
    require(launched["query_intersect"] == PIPELINE_QUERIES,
            f"pipeline: {launched}")
    log(f"pipeline: {rows_out}")
    return {"queries": rows_out, "launches": launched,
            "batch": PIPELINE_BATCH, "seq_len": PIPELINE_SEQ}


def coordinator_phase(ctx, counted) -> dict:
    """A ``FleetCoordinator`` at cadence COORD_CADENCE over the prefix:
    COORD_WORKERS worker threads route their chunks on private replicas of
    an untightened tree (``ShardIngestor``, each on its own CUDA stream)
    and submit two partials each, and one more worker submits one and
    leaves before the last fold; then ``LayoutService.ingest`` of the
    prefix in rounds with ``IngestOptions(shards=COORD_WORKERS,
    coordinator=)``.  Both publish descriptions and block sizes equal to a
    single-stream ingest's and the numpy oracle's."""
    import threading

    import torch

    from repro_torch.coordinator import FleetCoordinator
    from repro_torch.core.qdtree import FrozenQdTree
    from repro_torch.engine import LayoutEngine, replicate_tree
    from repro_torch.engine.sharded import ShardIngestor, micro_batches
    from repro_torch.service import IngestOptions, LayoutService

    dev, rec_dev = ctx["dev"], ctx["rec_dev"]
    n_pre, oracle = ctx["n_rows"], ctx["oracle_tree"]
    prefix = rec_dev[:n_pre]
    single = LayoutEngine(FrozenQdTree.from_arrays(ctx["untightened"]),
                          device=dev)
    single.ingest(ctx["slices"])
    require(leaves_equal(single.tree, oracle), "single stream vs oracle")

    def check(tree, what):
        require(leaves_equal(tree, oracle)
                and np.array_equal(tree.block_sizes, oracle.block_sizes),
                f"{what}: published descriptions differ from the oracle's")
        require(leaves_equal(tree, single.tree), f"{what}: vs single stream")

    svc = LayoutService(FrozenQdTree.from_arrays(ctx["untightened"]),
                        device=dev)
    fold_ms, reports = [], []
    coord = FleetCoordinator(svc, cadence=COORD_CADENCE,
                             on_fold=reports.append)
    chunks = torch.tensor_split(prefix, 2 * COORD_WORKERS + 1)
    handles = [coord.register(f"ingest-{i}") for i in range(COORD_WORKERS)]
    leaver = coord.register("leaver")
    lock = threading.Lock()
    errors = []

    # private replicas, made before any fold publishes into the live tree
    engines = [LayoutEngine(replicate_tree(svc.tree), device=dev,
                            plan_cache=svc.plans)
               for _ in range(COORD_WORKERS + 1)]

    def submit(i, handle, rows):
        state = ShardIngestor(engines[i]).run(
            micro_batches(rows, COORD_BATCH))
        with lock:  # submissions in turn, so a fold is timed alone
            t0 = time.perf_counter()
            rep = coord.submit(handle, state=state,
                               generation=svc.generation)
            if rep is not None:
                fold_ms.append((time.perf_counter() - t0) * 1e3)

    def worker(i):
        try:
            for c in (chunks[2 * i], chunks[2 * i + 1]):
                submit(i, handles[i], c)
        except BaseException as e:
            errors.append(e)

    def fleet():
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(COORD_WORKERS)]
        for t in threads:
            t.start()
        # one partial while the others stream, then it leaves: its
        # partial stays pending and folds with theirs
        submit(COORD_WORKERS, leaver, chunks[-1])
        coord.leave(leaver)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        t0 = time.perf_counter()
        if coord.stats()["pending"]:
            coord.fold()
            fold_ms.append((time.perf_counter() - t0) * 1e3)

    counted("coordinator", fleet)
    check(svc.tree, "coordinator fold")
    stats = coord.stats()
    require(stats["accumulated_records"] == n_pre
            and stats["stale_dropped"] == 0
            and [w.name for w in coord.workers()] == [
                h.name for h in handles],
            f"coordinator counters {stats}")
    # the service's own fleet path: thread shards on the card, no local
    # publish, the coordinator folding every COORD_CADENCE rounds
    svc2 = LayoutService(FrozenQdTree.from_arrays(ctx["untightened"]),
                         device=dev)
    coord2 = FleetCoordinator(svc2, cadence=COORD_CADENCE)

    def rounds():
        reps = [svc2.ingest(part, IngestOptions(shards=COORD_WORKERS,
                                                coordinator=coord2))
                for part in torch.tensor_split(prefix, COORD_CADENCE)]
        require(not any(r.published for r in reps),
                "a coordinated round published locally")
        return reps

    counted("coordinator_service", rounds)
    check(svc2.tree, "service ingest with a coordinator")
    out = {
        "workers": COORD_WORKERS + 1, "cadence": COORD_CADENCE,
        "fold_ms": fold_ms, "folds": [
            {k: v for k, v in vars(r).items() if k != "drift"}
            for r in reports],
        "stats": stats, "service_stats": coord2.stats(),
        "launches": ctx["path_launches"]["coordinator"],
        "service_launches": ctx["path_launches"]["coordinator_service"],
    }
    log(f"coordinator: folds {out['folds']} in {fold_ms} ms; {stats}; the "
        f"service's rounds {coord2.stats()}")
    return out


def cli_start(ctx) -> dict:
    """Both command lines started as subprocesses on the card, side by
    side (``cli_phase`` reads them; they run beside the phases between)."""
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="qd-cli-"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmds = {
        "ingest": [sys.executable, "-m", "repro_torch.launch.ingest",
                   "--rows", str(CLI_INGEST_ROWS), "--shards", "2",
                   "--coordinator", "--track-workload", "--drift",
                   "--store", str(tmp / "store"), *CLI_DEVICE_ARGS],
        "serve": [sys.executable, "-m", "repro_torch.launch.serve",
                  "--rows", str(CLI_SERVE_ROWS), "--duration",
                  str(CLI_SERVE_S), "--workload", "auto",
                  *CLI_DEVICE_ARGS],
    }
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, c in cmds.items()}
    ctx["children"].extend(procs.values())
    return {"procs": procs, "tmp": tmp, "t0": t0}


def examples_runs(children: list) -> dict:
    """The examples on the card and qdlint's self-test and scan on the
    host, in EXAMPLE_LANES: → each one's exit code, seconds and the tail
    of its output."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": EXAMPLES_THREADS}
    cmds = {name: [sys.executable, str(ROOT / "examples_torch" / name),
                   *args, *CLI_DEVICE_ARGS]
            for name, args in EXAMPLES.items()}
    cmds.update({name: [sys.executable, "-m", "repro_torch.analysis", *args]
                 for name, args in QDLINT.items()})
    out = {}

    def lane(names):
        for name in names:
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmds[name], cwd=ROOT, env=env, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
            children.append(proc)
            try:
                stdout, stderr = proc.communicate(timeout=EXAMPLES_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            out[name] = {"rc": proc.returncode,
                         "s": time.perf_counter() - t0,
                         "stdout": stdout[-1500:], "stderr": stderr[-1500:]}

    with ThreadPoolExecutor(len(EXAMPLE_LANES)) as lanes:
        list(lanes.map(lane, EXAMPLE_LANES))
    return {name: out[name] for name in cmds}


def examples_phase(ctx) -> dict:
    """The runs of ``examples_runs`` (``ctx["examples_job"]``): every
    example exits 0 with its ``OK`` line, qdlint's self-test passes and
    its scan of the port finds nothing."""
    t0 = time.perf_counter()
    runs = ctx["examples_job"].result(
        timeout=EXAMPLES_TIMEOUT_S * max(map(len, EXAMPLE_LANES)))
    wait_s = time.perf_counter() - t0
    for name, r in runs.items():
        require(r["rc"] == 0, f"{name} exited {r['rc']}: {r['stderr']}")
        log(f"{name}: exit {r['rc']} in {r['s']:.2f}s")
    for name in EXAMPLES:
        require(f"{name[:-3]} OK" in runs[name]["stdout"],
                f"{name} printed no OK line: {runs[name]['stdout']}")
    require("[qdlint self-test] PASS" in runs["qdlint_self_test"]["stdout"],
            f"qdlint self-test: {runs['qdlint_self_test']['stdout']}")
    require("qdlint: 0 finding(s)" in runs["qdlint_scan"]["stdout"],
            f"qdlint scan: {runs['qdlint_scan']['stdout']}")
    return {"wait_s": wait_s,
            "runs": {k: {"rc": r["rc"], "s": r["s"]}
                     for k, r in runs.items()}}


def cli_phase(ctx, started: dict) -> dict:
    """The command lines of ``cli_start``: each exits 0 and its summary
    line shows no stale response, no plan built while serving and a swap
    note (serve), folds and a store (ingest)."""
    import shutil

    procs, tmp, t0 = started["procs"], started["tmp"], started["t0"]
    out = {}

    def wait(name):
        stdout, stderr = procs[name].communicate(timeout=CLI_TIMEOUT_S)
        return stdout, stderr, time.perf_counter() - t0

    try:
        with ThreadPoolExecutor(len(procs)) as waiters:
            done = {k: waiters.submit(wait, k) for k in procs}
            for name, fut in done.items():
                stdout, stderr, wall = fut.result()
                rc = procs[name].returncode
                require(rc == 0, f"{name} CLI exited {rc}: "
                                 f"{stderr[-2000:]}")
                summary = json.loads(stdout.strip().splitlines()[-1])
                out[name] = {"wall_s": wall, "summary": summary}
                ctx["worker_launches"].append(summary["launches"])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    s = out["serve"]["summary"]
    require(s["device"].startswith("cuda") and s["stale_responses"] == 0
            and s["serve_builds"] == {} and s["swap"] is not None
            and "swapped" in s["swap"]
            and s["launches"]["query_intersect"] > 0,
            f"serve CLI summary: {s}")
    i = out["ingest"]["summary"]
    require(i["device"].startswith("cuda") and i["n_records"] ==
            CLI_INGEST_ROWS and i["coordinator"]["folds"] >= 1
            and i["launches"]["fused_ingest_shared"] > 0,
            f"ingest CLI summary: {i}")
    log(f"CLIs on the card: serve {s['served']} served, hit rate "
        f"{s['hit_rate']:.4f}, swap {s['swap']}; ingest "
        f"{i['n_records']} records, {i['coordinator']['folds']} folds")
    return {
        "serve": {k: s[k] for k in (
            "served", "rejected", "qps_achieved", "hit_rate", "p50_ms",
            "p99_ms", "stale_responses", "serve_builds", "swap_builds",
            "swap", "generation", "n_blocks", "launches")},
        "ingest": {k: i[k] for k in (
            "n_records", "n_batches", "records_per_s", "n_blocks",
            "ingest_builds", "scanned_fraction", "coordinator", "drift",
            "workload_tracking", "launches")},
        "wall_s": {k: v["wall_s"] for k, v in out.items()},
    }


def lm_decode_forced(params, cfg, batch, tokens, max_seq: int):
    """Prefill ``batch``, then decode feeding ``tokens`` (B, n) in turn:
    (prefill logits (B, V), the n-1 steps' logits (B, n-1, V))."""
    import torch

    from repro_torch.launch import serve_lm
    from repro_torch.models import model

    b, plen = batch["tokens"].shape
    last, pre = model.prefill(params, batch, cfg)
    caches, _ = model.init_caches(cfg, b, max_seq, tokens.device)
    caches = serve_lm._splice(cfg, caches, pre, plen)
    steps = []
    for i in range(tokens.shape[1] - 1):
        lg, caches = model.decode_step(params, caches, tokens[:, i:i + 1],
                                       plen + i, cfg)
        steps.append(lg)
    return last, torch.stack(steps, dim=1)


def lm_traced(fn, calls: int) -> dict:
    """``calls`` calls of ``fn`` under ``torch.profiler``: host wall, the
    union of device activity, device ops a call, and the LM_TRACE_TOP
    ops by device time and by host time (ms over the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = trace_counts(prof)["busy_ms"]
    ops = sum(1 for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA)
    avg = prof.key_averages()

    def top(key):
        rows = sorted(avg, key=lambda e: getattr(e, key), reverse=True)
        return [(e.key[:LM_OP_NAME], e.count, getattr(e, key) / 1e3)
                for e in rows[:LM_TRACE_TOP]]

    return {"calls": calls, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms,
            "device_ops_per_call": ops / calls,
            "top_device_ms": top("self_device_time_total"),
            "top_host_ms": top("self_cpu_time_total")}


def lm_trace(params, cfg, batch, toks) -> dict:
    """A prefill, then LM_TRACE_STEPS decode steps, each window traced
    (``lm_traced``)."""
    from repro_torch.launch import serve_lm
    from repro_torch.models import model
    from repro_torch.train import steps

    box = {}

    def prefill():
        box["pre"] = model.prefill(params, batch, cfg)[1]

    pre_trace = lm_traced(prefill, 1)
    caches, _ = model.init_caches(cfg, LM_BATCH, LM_MAX_SEQ, toks.device)
    box["caches"] = serve_lm._splice(cfg, caches, box.pop("pre"), LM_PROMPT)
    box["tok"], box["pos"] = toks[:, :1], LM_PROMPT

    def step():
        box["tok"], _, box["caches"] = steps.serve_step(
            params, box["caches"], box["tok"], box["pos"], cfg)
        box["pos"] += 1

    return {"prefill": pre_trace, "decode": lm_traced(step, LM_TRACE_STEPS)}


def lm_full_model(arch: str, dev) -> dict:
    """One model at full width and depth in its own dtypes: weights drawn
    on the card, ``serve_lm.generate`` timed after a short warm-up, the
    tokens in the vocabulary and the logits finite; then, with the same
    weights under ``compute_dtype="float32"``, the teacher-forced logits
    of the generated sequence at positions LM_PROMPT.. against the decode
    steps'."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import common, model, transformer

    cfg = get_config(arch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, _ = model.init_model(common.make_generator(SEED, dev), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = serve_lm.make_batch(cfg, LM_BATCH, LM_PROMPT, SEED, dev)
    serve_lm.generate(params, cfg, batch, 2, LM_MAX_SEQ)  # warm-up
    res = serve_lm.generate(params, cfg, batch, LM_GEN, LM_MAX_SEQ)
    peak = torch.cuda.max_memory_allocated() - base
    toks = res["tokens"]
    require(tuple(toks.shape) == (LM_BATCH, LM_GEN)
            and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
            f"{arch}: tokens {tuple(toks.shape)} outside the vocabulary")
    require(bool(torch.isfinite(res["logits"].float()).all())
            and bool(torch.isfinite(res["prefill_logits"].float()).all()),
            f"{arch}: non-finite logits in {cfg.compute_dtype}")
    step_ms = res["step_ms"]
    decode_s = sum(step_ms) / 1e3
    trace = lm_trace(params, cfg, batch, toks)

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    seq = torch.cat([batch["tokens"], toks[:, :-1]], dim=1)
    with torch.no_grad():
        full, _, _ = transformer.decoder_forward(params, seq, cfg32)
    pre = {"tokens": batch["tokens"]}
    _, steps = lm_decode_forced(params, cfg32, pre, toks[:, :LM_GEN],
                                LM_MAX_SEQ)
    want = full[:, LM_PROMPT:]  # positions LM_PROMPT .. S-1
    err = float((steps - want).abs().max())
    rel = float(((steps - want).abs()
                 / want.abs().clamp_min(LM_F32_ATOL)).max())
    require(bool(torch.allclose(steps, want, rtol=LM_F32_RTOL,
                                atol=LM_F32_ATOL)),
            f"{arch}: float32 decode logits differ from the teacher-forced "
            f"ones by {err} (rtol {LM_F32_RTOL}, atol {LM_F32_ATOL})")
    out = {
        "params": model.param_count(params),
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "model_flops_per_token": model.model_flops_per_token(cfg),
        "init_s": init_s, "prefill_ms": res["prefill_ms"],
        "decode_ms_per_step": float(np.median(step_ms)),
        "decode_ms_per_step_spread": spread(step_ms),
        "tokens_per_s": LM_BATCH * (LM_GEN - 1) / decode_s,
        "peak_device_gb": peak / 1e9,
        # a decode step reads every parameter at least once
        "decode_bound_ms": sum(
            t.numel() * t.element_size() for t in model.leaves(params))
        / HBM_BYTES_PER_S * 1e3,
        "trace": trace,
        "f32_decode_vs_forced_max_abs_err": err,
        "f32_decode_vs_forced_max_rel_err": rel,
        "f32_logits_max_abs": float(want.abs().max()),
        "sample": toks[0, :8].tolist(),
    }
    del params, res, full
    torch.cuda.empty_cache()
    return out


def lm_reduced_arch(arch: str, dev, host: ThreadPoolExecutor):
    """One reduced arch: weights drawn on the CPU and copied to the card;
    greedy generation on the card, then on a ``host`` thread the CPU port
    fed the card's tokens: prefill and every step's logits within
    LM_CARD_*, and each greedy token the CPU's argmax unless its top-2
    gap is under LM_GAP_TOL.  → the future of the check's result."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import common, model

    cfg = get_config(arch).reduced(max_positions=LM_MAX_SEQ)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    cpu = torch.device("cpu")
    params, _ = model.init_model(common.make_generator(SEED, cpu), cfg)
    batch = serve_lm.make_batch(cfg, LM_BATCH, LM_SMALL_PROMPT, SEED, cpu)
    res = serve_lm.generate(model.to_device(params, dev), cfg,
                            model.to_device(batch, dev), LM_SMALL_GEN,
                            LM_MAX_SEQ)
    toks = res["tokens"].cpu()
    got = torch.cat([res["prefill_logits"][:, None], res["logits"]],
                    dim=1).cpu()
    return host.submit(lm_reduced_check, arch, cfg, params, batch, toks, got)


def lm_reduced_check(arch, cfg, params, batch, toks, got) -> dict:
    import torch

    last, steps = lm_decode_forced(params, cfg, batch, toks, LM_MAX_SEQ)
    want = torch.cat([last[:, None], steps], dim=1)
    err = float((got - want).abs().max())
    require(bool(torch.allclose(got, want, rtol=LM_CARD_RTOL,
                                atol=LM_CARD_ATOL)),
            f"{arch}: card logits differ from the CPU port's by {err}")
    top2 = want.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < LM_GAP_TOL
    differ = want.argmax(dim=-1).to(toks.dtype) != toks
    require(not bool((differ & ~near).any()),
            f"{arch}: a greedy token differs from the CPU's argmax away "
            f"from a tie")
    return {"max_abs_err": err, "tokens_differ": int(differ.sum()),
            "near_ties": int(near.sum()), "steps": LM_SMALL_GEN - 1}


def lm_serve_phase(ctx, counted) -> dict:
    """The LM serving path (``repro_torch.launch.serve_lm`` over the
    models): LM_FULL at full width (``lm_full_model``), the ten reduced
    archs against the CPU port (``lm_reduced_arch``), and the CLI at its
    defaults as a subprocess on the card.  The path launches none of the
    repo's kernels: its launch counts stay 0."""
    from repro_torch.configs import ARCHS

    dev = ctx["dev"]
    out = {"full": {}, "reduced": {}}
    # the CLI as a subprocess beside the in-process path (it launches no
    # kernel of the repo either; its times are its own)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_lm",
         *CLI_DEVICE_ARGS], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    ctx["children"].append(proc)

    def path():
        for arch in LM_FULL:
            out["full"][arch] = r = lm_full_model(arch, dev)
            log(f"lm {arch}: prefill {r['prefill_ms']:.3f} ms, decode "
                f"{r['decode_ms_per_step']:.3f} ms/step, "
                f"{r['tokens_per_s']:.1f} tok/s, peak "
                f"{r['peak_device_gb']:.3f} GB, f32 check max err "
                f"{r['f32_decode_vs_forced_max_abs_err']:.3g}")
        with ThreadPoolExecutor(LM_HOST_THREADS) as host:
            checks = {arch: lm_reduced_arch(arch, dev, host)
                      for arch in sorted(ARCHS)}
            for arch, fut in checks.items():
                out["reduced"][arch] = fut.result()

    counted("lm_serve", path)
    require(not any(ctx["path_launches"]["lm_serve"].values()),
            f"the LM path launched a kernel: "
            f"{ctx['path_launches']['lm_serve']}")
    try:
        stdout, stderr = proc.communicate(timeout=LM_CLI_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(proc.returncode == 0,
            f"serve_lm exited {proc.returncode}: {stderr[-2000:]}")
    summary = json.loads(stdout.strip().splitlines()[-1])
    require(summary["device"].startswith(dev.type)
            and summary["tokens_shape"] == [4, 32] and summary["in_vocab"],
            f"serve_lm summary: {summary}")
    out["cli"] = {"wall_s": time.perf_counter() - t0, "summary": summary}
    return out


def lm_cli(args: list, children: list):
    """``python -m repro_torch.launch.train`` with ``args`` on the card
    (``CLI_DEVICE_ARGS``), started and added to ``children`` (which
    ``main`` kills, if still running, on its way out)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *args,
         *CLI_DEVICE_ARGS], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    children.append(proc)
    return proc


def lm_cli_result(proc, timeout: float, what: str, expect_rc: int = 0):
    """Wait for an ``lm_cli`` run: (its summary or None, stderr, wall)."""
    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(proc.returncode == expect_rc,
            f"{what}: exit {proc.returncode}, expected {expect_rc}: "
            f"{err[-2000:]}")
    summary = (json.loads(out.strip().splitlines()[-1]) if expect_rc == 0
               else None)
    return summary, err, time.perf_counter() - t0


def lm_train_bound(cfg) -> dict:
    """A train step's least time on the card: the bytes of the AdamW pass
    (read p, g, m, v; write p, m, v, fp32) and of each microbatch's casts
    of the float32 weights that meet a matmul to bf16 (read 4 B, write
    2 B), at 3.35 TB/s; and the model flops of the step's tokens at the
    dense bf16 peak.  Counted from the code and the config."""
    from repro_torch.models import model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps

    shapes, _ = steps.abstract_state(cfg, opt_lib.AdamWConfig())
    cast = 0

    def walk(t, name=""):
        nonlocal cast
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, k)
        elif isinstance(t, list):
            for v in t:
                walk(v, name)
        elif t.dim() >= 2 and name not in LM_UNCAST:
            cast += t.numel()

    walk(shapes["params"])
    n = model.param_count(shapes["params"])
    nbytes = 4 * 7 * n + max(cfg.microbatches, 1) * 6 * cast
    flops = model.model_flops_per_token(cfg) * LM_TRAIN_TOKENS
    ms, by = bound(nbytes, 0)
    flop_ms = flops / BF16_FLOPS_PER_S * 1e3
    if flop_ms > ms:
        ms, by = flop_ms, "operations"
    return {"bytes": nbytes, "cast_params": cast, "model_flops": flops,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "flops_ms": flop_ms,
            "bound_ms": ms, "bound_by": by}


def lm_train_full(arch: str, children: list) -> dict:
    """``python -m repro_torch.launch.train --arch <arch> --full-arch
    --steps LM_TRAIN_STEPS`` on the card at the CLI's defaults,
    through its one-rank (data 1, model 1) mesh: exit 0, every loss
    finite, the data tier's kernels launched; step ms (median of steps
    2.., the first being the warm one), tokens/s, MFU, peak GB and the
    step's bound."""
    from repro_torch.configs import get_config
    from repro_torch.models import model

    steps = LM_TRAIN_STEPS
    summary, _, wall = lm_cli_result(
        lm_cli(["--arch", arch, "--full-arch", "--steps", str(steps)],
               children),
        LM_TRAIN_TIMEOUT_S, f"train CLI {arch}")
    cfg = get_config(arch)
    losses = summary["losses"]
    require(summary["device"].startswith("cuda") and summary["full_arch"]
            and summary["steps"] == list(range(steps))
            and all(np.isfinite(losses))
            and summary["batch"] * summary["seq"] == LM_TRAIN_TOKENS
            and summary["mesh"] == {"data": 1, "model": 1}
            and not summary["dtensor_leaves"],
            f"train CLI {arch}: {summary}")
    launches = summary["launches"]
    require(fused_launches(launches) > 0
            and launches["query_intersect"] > 0,
            f"train CLI {arch}: the data tier launched {launches}")
    step_s = summary["step_ms_median"] / 1e3
    flops = model.model_flops_per_token(cfg) * LM_TRAIN_TOKENS
    return {
        "wall_s": wall, "params": summary["params"],
        "microbatches": summary["microbatches"], "remat": summary["remat"],
        "losses": losses, "grad_norms": summary["grad_norms"],
        "step_ms": summary["step_ms"], "step_ms_median": step_s * 1e3,
        "step_ms_spread": spread(summary["step_ms"][1:]),
        "tokens_per_s": LM_TRAIN_TOKENS / step_s,
        "mfu": flops / step_s / BF16_FLOPS_PER_S,
        "peak_gb": summary["peak_gb"], "bound": lm_train_bound(cfg),
        "dtensor_leaves": summary["dtensor_leaves"],
        "blocks": summary["blocks"],
        "blocks_skipped": summary["blocks_skipped"], "launches": launches,
    }


def lm_train_batch(cfg, dev, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab, (LM_TRAIN_BATCH, LM_TRAIN_SEQ + 1))
    import torch

    t = torch.from_numpy(t.astype(np.int32)).to(dev)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def lm_train_trace(dev) -> dict:
    """One starcoder2-3b step at full width in its own dtypes, in this
    process, after a warm one: the whole step under ``torch.profiler``
    (busy share, device ops), then the same step's parts traced apart —
    each microbatch's forward, its backward with the accumulation, and
    the AdamW update — by the functions ``train_step`` is made of."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import common, model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import schedule as sched
    from repro_torch.train import steps

    cfg = get_config(LM_FULL[0])
    ocfg, scfg = opt_lib.AdamWConfig(), sched.ScheduleConfig(
        peak_lr=3e-4, warmup_steps=2, total_steps=LM_TRAIN_STEPS)
    state = steps.init_train_state(common.make_generator(SEED, dev), cfg,
                                   ocfg)
    batch = lm_train_batch(cfg, dev, SEED)
    box = {"state": state}

    def step():
        box["state"], box["m"] = steps.train_step(box["state"], batch, cfg,
                                                  ocfg, scfg)
        float(box["m"]["loss"])

    step()  # warm
    whole = lm_traced(step, 1)
    k = cfg.microbatches
    micro = steps.split_microbatches(batch, k)
    params = box["state"]["params"]

    def forward():
        box["fw"] = [steps.microbatch_loss(params, mb, cfg) for mb in micro]

    def backward():
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in model.leaves(params)]
        for loss, _, live in box.pop("fw"):
            for a, g in zip(acc, steps.microbatch_grads(loss, live)):
                a.add_(g.to(torch.float32) / k)
        it = iter(acc)
        box["grads"] = model.tree_map(lambda _: next(it), params)

    def optimizer():
        opt_lib.adamw_update(params, box.pop("grads"), box["state"]["opt"],
                             sched.warmup_cosine(box["state"]["step"], scfg),
                             ocfg)

    parts = {"forward": lm_traced(forward, 1),
             "backward": lm_traced(backward, 1),
             "optimizer": lm_traced(optimizer, 1)}
    del box, state, params, micro
    torch.cuda.empty_cache()
    return {"step": whole, "parts": parts}


def lm_leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def lm_train_f32(dev) -> dict:
    """Float32 (TF32 off) checks.  starcoder2-3b at full width: the
    gradients the first step puts in m (m = 0.1·clip·g at count 1) with
    its 2 microbatches against 1, on named leaves, through the step's
    own gradient path (``_grads_and_metrics``; the moments are not
    allocated: a float32 state with the accumulator, 76 GB, does not fit
    beside this process's own).  Then remat on against off on its
    reduced config."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import common, model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import steps

    ocfg = opt_lib.AdamWConfig()
    cfg = dataclasses.replace(get_config(LM_FULL[0]),
                              compute_dtype="float32")
    params, _ = model.init_model(common.make_generator(SEED, dev), cfg)
    batch = lm_train_batch(cfg, dev, SEED + 1)
    ms, losses = {}, {}
    for k in (cfg.microbatches, 1):
        grads, metrics = steps._grads_and_metrics(
            params, batch, dataclasses.replace(cfg, microbatches=k))
        gnorm = opt_lib.global_norm(grads)
        clip = torch.clamp(ocfg.max_grad_norm / (gnorm + 1e-12), max=1.0)
        ms[k] = {"/".join(map(str, p)): ((1.0 - ocfg.b1) * clip
                                          * lm_leaf(grads, p)).cpu()
                 for p in LM_F32_LEAVES}
        losses[k] = float(metrics["loss"])
        del grads
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    mb = {}
    for name, want in ms[1].items():
        got = ms[cfg.microbatches][name]
        mb[name] = float((got - want).abs().max()
                         / want.abs().max().clamp_min(1e-30))
    require(max(mb.values()) <= LM_MB_RTOL,
            f"float32 starcoder2-3b, m after step 1 with "
            f"{cfg.microbatches} microbatches against 1: {mb} (rtol "
            f"{LM_MB_RTOL})")

    small = get_config(LM_FULL[0]).reduced()
    sp, _ = model.init_model(common.make_generator(SEED, dev), small)
    sb = lm_train_batch(small, dev, SEED + 2)
    on, m_on = steps.loss_and_grads(sp, sb, small)
    off, m_off = steps.loss_and_grads(
        sp, sb, dataclasses.replace(small, remat=False))
    remat_err = max(float((a - b).abs().max()
                          / b.abs().max().clamp_min(1e-30))
                    for a, b in zip(on, off))
    require(remat_err <= LM_REMAT_RTOL
            and float(m_on["loss"]) == float(m_off["loss"]),
            f"remat on against off: grads {remat_err} apart (rtol "
            f"{LM_REMAT_RTOL}), loss {float(m_on['loss'])} vs "
            f"{float(m_off['loss'])}")
    return {"microbatch_m_max_rel_err": mb, "losses": losses,
            "remat_grads_max_rel_err": remat_err,
            "remat_bitwise": all(torch.equal(a, b) for a, b in zip(on, off))}


def lm_train_case(arch: str):
    """(cfg, AdamW config, schedule, the initial state drawn on the CPU,
    the batches) of one reduced arch's card-against-CPU check.  An arch
    with int8 moments trains at lr 0 (``LM_TRAIN_CARD_LR`` says why)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve_lm
    from repro_torch.models import common
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import schedule as sched
    from repro_torch.train import steps

    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    ocfg = opt_lib.AdamWConfig(eight_bit=cfg.opt_8bit)
    scfg = sched.ScheduleConfig(
        peak_lr=0.0 if cfg.opt_8bit else LM_TRAIN_CARD_LR, warmup_steps=1,
        total_steps=10)
    cpu = torch.device("cpu")
    state = steps.init_train_state(common.make_generator(SEED, cpu), cfg,
                                   ocfg)
    batches = []
    for i in range(LM_TRAIN_CARD_STEPS):
        batch = serve_lm.make_batch(cfg, 4, 32, SEED + i, cpu)
        batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
        batches.append(batch)
    return cfg, ocfg, scfg, state, batches


def lm_train_host(arch: str) -> dict:
    """The CPU half of ``lm_train_reduced``, run in a pool worker: the
    metrics of each step and the state's leaves after the last."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.models import model
    from repro_torch.train import steps

    cfg, ocfg, scfg, state, batches = lm_train_case(arch)
    metrics = []
    for batch in batches:
        state, m = steps.train_step(state, batch, cfg, ocfg, scfg)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    return {"metrics": metrics,
            "leaves": [t.numpy() for t in model.leaves(state)]}


def lm_train_reduced(arch: str, dev, host: dict) -> dict:
    """One reduced arch on the card against the CPU (``host``, from
    ``lm_train_host``): the same state and batches, LM_TRAIN_CARD_STEPS
    train steps; loss, grad norm and lr each step, then params, m and v,
    within LM_TRAIN_CARD_* (each float leaf against its own max |x|; int8
    codes within 1, a rounding tie)."""
    import torch

    from repro_torch.models import model
    from repro_torch.train import steps

    cfg, ocfg, scfg, state, batches = lm_train_case(arch)
    card = model.to_device(state, dev)
    metric_err = 0.0
    for batch, mh in zip(batches, host["metrics"]):
        card, mc = steps.train_step(card, model.to_device(batch, dev), cfg,
                                    ocfg, scfg)
        for key, want in mh.items():
            metric_err = max(metric_err, abs(float(mc[key]) - want)
                             / max(abs(want), 1e-30))
    leaf_err, codes = 0.0, 0
    got = list(model.leaves(card))
    require(len(got) == len(host["leaves"]),
            f"{arch}: card state differs in layout")
    for a, b in zip(host["leaves"], got):
        a, b = torch.from_numpy(a), b.cpu()
        require(a.dtype == b.dtype and a.shape == b.shape,
                f"{arch}: card state differs in layout")
        if a.dtype == torch.int8:
            d = int((a.int() - b.int()).abs().max())
            require(d <= 1, f"{arch}: int8 codes {d} apart")
            codes += int((a != b).sum())
        elif a.is_floating_point():
            err = float((a - b).abs().max())
            scale = float(a.abs().max())
            require(err <= LM_TRAIN_CARD_RTOL * scale + LM_TRAIN_CARD_ATOL,
                    f"{arch}: a state leaf {err} apart (max {scale})")
            leaf_err = max(leaf_err, err / max(scale, 1e-30))
        else:
            require(torch.equal(a, b), f"{arch}: step counters differ")
    require(metric_err <= LM_TRAIN_CARD_RTOL,
            f"{arch}: loss/grad norm {metric_err} apart on the card")
    return {"metrics_max_rel_err": metric_err,
            "state_max_rel_err": leaf_err, "int8_codes_differ": codes,
            "opt_8bit": cfg.opt_8bit, "loss": float(mc["loss"])}


def lm_train_cli_runs(ck: Path, children: list) -> dict:
    """The train CLI's runs of the ``lm_train`` path, one after another on
    a thread while the main path's host work (data, greedy, the finer
    layout's wait) leaves the card idle: at reduced size a run that fails
    at step LM_FAIL_AT (checkpoints every LM_CKPT_EVERY) beside an
    uninterrupted run, then the resume from the crash's checkpoints
    (untimed); then LM_FULL at full width, one at a time
    (``lm_train_full``)."""
    resume_args = ["--steps", str(LM_RESUME_STEPS), "--ckpt-every",
                   str(LM_CKPT_EVERY), "--ckpt-dir", str(ck)]
    crash = lm_cli(resume_args + ["--fail-at", str(LM_FAIL_AT)], children)
    whole = lm_cli(["--steps", str(LM_RESUME_STEPS)], children)
    _, err, _ = lm_cli_result(crash, LM_TRAIN_TIMEOUT_S, "crash run",
                              expect_rc=1)
    require(f"injected failure at step {LM_FAIL_AT}" in err,
            f"crash run: {err[-2000:]}")
    resumed, _, wall = lm_cli_result(lm_cli(resume_args, children),
                                     LM_TRAIN_TIMEOUT_S, "resumed run")
    ref, _, _ = lm_cli_result(whole, LM_TRAIN_TIMEOUT_S, "uninterrupted run")
    out = {"resumed": resumed, "uninterrupted": ref, "resume_wall_s": wall,
           "full": {}}
    for arch in LM_FULL[::-1]:  # the smaller first
        out["full"][arch] = r = lm_train_full(arch, children)
        log(f"lm train {arch}: step {r['step_ms_median']:.3f} ms, "
            f"{r['tokens_per_s']:.1f} tok/s, MFU {r['mfu']:.4f}, peak "
            f"{r['peak_gb']:.3f} GB, losses {r['losses']}")
    return out


def lm_train_phase(ctx, counted) -> dict:
    """The LM training path: the train CLI's runs (``ctx["lm_cli"]``,
    from ``lm_train_cli_runs`` before the main path: LM_FULL at full width,
    and the crash at step LM_FAIL_AT and its resume at reduced size against
    an uninterrupted run), one starcoder2-3b step traced in this process
    (``lm_train_trace``), the float32 microbatch and remat checks
    (``lm_train_f32``), and the ten reduced archs on the card against the
    CPU (``lm_train_reduced``; the CPU halves ran in the pool,
    ``ctx["lm_host_jobs"]``).  The data tier's kernels run in the CLIs
    (their summaries count them); the in-process work launches none."""
    import torch

    from repro_torch.configs import ARCHS

    dev = ctx["dev"]
    out = {"full": {}, "reduced": {}}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["allocated_at_start_gb"] = torch.cuda.memory_allocated() / 1e9
    runs = ctx["lm_cli"]
    for arch in LM_FULL:
        out["full"][arch] = runs["full"][arch]
        ctx["worker_launches"].append(runs["full"][arch]["launches"])
    def path():
        out["trace"] = lm_train_trace(dev)
        out["f32"] = lm_train_f32(dev)
        for arch in sorted(ARCHS):
            host = ctx["lm_host_jobs"][arch].get(timeout=LM_TRAIN_TIMEOUT_S)
            out["reduced"][arch] = lm_train_reduced(arch, dev, host)

    counted("lm_train", path)
    require(not any(ctx["path_launches"]["lm_train"].values()),
            f"the in-process LM training launched a kernel: "
            f"{ctx['path_launches']['lm_train']}")
    resumed, ref = runs["resumed"], runs["uninterrupted"]
    start = LM_FAIL_AT // LM_CKPT_EVERY * LM_CKPT_EVERY
    require(resumed["start"] == start and resumed["steps"] == list(
        range(start, LM_RESUME_STEPS)),
        f"resume: started at {resumed['start']}, steps {resumed['steps']}")
    want = np.asarray(ref["losses"][start:])
    got = np.asarray(resumed["losses"])
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    require(rel <= LM_RESUME_RTOL,
            f"resumed losses {got.tolist()} against {want.tolist()}")
    for s in (ref, resumed):
        require(fused_launches(s["launches"]) > 0
                and s["launches"]["query_intersect"] > 0,
                f"a reduced train CLI's data tier launched {s['launches']}")
        ctx["worker_launches"].append(s["launches"])
    out["resume"] = {"start": resumed["start"], "steps": resumed["steps"],
                     "losses": resumed["losses"],
                     "uninterrupted": ref["losses"][start:],
                     "max_rel_err": rel,
                     "bitwise": bool(np.array_equal(got, want)),
                     "wall_s": runs["resume_wall_s"]}
    log(f"lm train resume: from {start}, losses {rel:.3g} apart "
        f"(bitwise {out['resume']['bitwise']})")
    return out

def same_bits(a, b) -> bool:
    """Two tensors equal bit for bit (the sign of a zero too)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    a, b = a.contiguous(), b.contiguous()
    if a.is_floating_point():
        a, b = (t.view(ints[t.element_size()]) for t in (a, b))
    return bool(torch.equal(a, b))


def lm_shard_nccl(prof) -> dict:
    """NCCL kernels in a profiler trace: {kernel name: count}."""
    import torch

    out: dict = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and "nccl" in ev.name.lower()):
            out[ev.name[:LM_OP_NAME]] = out.get(ev.name[:LM_OP_NAME], 0) + 1
    return out


def lm_shard_moe(arch: str, dev, mesh) -> dict:
    """One MoE layer of ``arch`` at its published widths in its dtypes,
    drawn on the card: forward and backward through the sharded body under
    the one-rank mesh (``moe_forward`` under ``use_mesh``: real NCCL
    all-to-all, all-gather and all-reduce calls) against ``_moe_local``
    on the same weights and input, with default algorithms.  y, aux and
    every gradient must be equal, bitwise, and finite, and each body must
    repeat itself bit for bit (the combine and the dispatch's backward sum
    each token's rows in a fixed order, with no atomics).  CUDA-event ms of
    each (median of LM_SHARD_REPS after a warm call) and the NCCL kernels
    of one traced sharded call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import common, mlp
    from repro_torch.sharding import specs as sh

    cfg = get_config(arch)
    params, _ = mlp.init_moe(common.make_generator(SEED, dev), cfg)
    b, s = LM_SHARD_TOKENS
    gen = common.make_generator(SEED + 1, dev)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev).to(
        common.cdtype(cfg))
    names = list(params)

    def run(sharded):
        ps = {k: params[k].detach().requires_grad_() for k in names}
        xx = x.detach().requires_grad_()
        if sharded:
            with sh.use_mesh(mesh, sh.Rules.make()):
                y, aux = mlp.moe_forward(ps, xx, cfg)
        else:
            y, aux = mlp._moe_local(ps, xx.reshape(b * s, -1), cfg)
            y = y.reshape(b, s, -1)
        loss = (y.float() ** 2).mean() + aux
        grads = torch.autograd.grad(loss, [ps[k] for k in names] + [xx])
        return y.detach(), aux.detach(), grads

    ms = {"sharded": time_ms(lambda: run(True), LM_SHARD_REPS),
          "local": time_ms(lambda: run(False), LM_SHARD_REPS)}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(True)
        torch.cuda.synchronize()
    nccl = lm_shard_nccl(prof)
    (y1, a1, g1), (y0, a0, g0) = run(True), run(False)
    repeats = {}
    for sharded, first in ((True, (y1, a1, g1)), (False, (y0, a0, g0))):
        again = run(sharded)
        repeats["sharded" if sharded else "local"] = all(
            same_bits(a, c) for a, c in zip(
                (first[0], first[1], *first[2]),
                (again[0], again[1], *again[2])))
        del again
    require(all(repeats.values()), f"{arch}: a body did not repeat itself "
            f"bit for bit: {repeats}")
    require(bool(torch.isfinite(y1.float()).all()) and all(
        bool(torch.isfinite(g.float()).all()) for g in g1),
        f"{arch}: a non-finite output or gradient")
    equal = {"y": torch.equal(y0, y1), "aux": torch.equal(a0, a1)}
    equal.update({n: torch.equal(a, c)
                  for n, a, c in zip(names + ["x"], g0, g1)})
    require(all(equal.values()), f"{arch}: the sharded body differs from "
            f"_moe_local: {equal}")
    require(nccl, f"{arch}: the traced sharded call ran no NCCL kernel")
    n = sum(int(p.numel()) for p in params.values())
    out = {"params": n, "param_gb": sum(int(p.numel()) * p.element_size()
                                        for p in params.values()) / 1e9,
           "moe_shard": cfg.moe_shard, "tokens": b * s, "equal": equal,
           "repeats_bitwise": repeats, "ms": ms, "nccl_kernels": nccl}
    del params, x, g0, g1
    torch.cuda.empty_cache()
    return out


def lm_shard_compress(dev, mesh) -> dict:
    """``jit_train_step`` for LM_SHARD_COMPRESS at full width on the
    one-rank (pod, data, model) mesh, plain and then compressed
    (``make_compressed_train_step``: int8 payload and row scales
    all-gathered over pod through NCCL), LM_SHARD_STEPS steps each from
    one seeded state on the same batches: every loss finite, the last
    compressed loss within LM_SHARD_LOSS_TOL of the plain one; step ms
    (host clock until the loss is on the host, median of steps 2..) and
    the sync's wire bytes against float32."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import common, model
    from repro_torch.sharding import specs as sh
    from repro_torch.train import compress as compress_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import schedule as sched
    from repro_torch.train import steps

    cfg = get_config(LM_SHARD_COMPRESS)
    ocfg = opt_lib.AdamWConfig(eight_bit=cfg.opt_8bit)
    scfg = sched.ScheduleConfig(peak_lr=3e-4, warmup_steps=2,
                                total_steps=LM_SHARD_STEPS)
    shapes = {n: torch.empty((LM_TRAIN_BATCH, LM_TRAIN_SEQ),
                             dtype=torch.int32, device="meta")
              for n in ("tokens", "labels")}
    bspec = {"tokens": ("batch", None), "labels": ("batch", None)}
    out = {}
    for compress in (False, True):
        step, _, ssh, bsh = steps.jit_train_step(
            cfg, ocfg, scfg, mesh, sh.Rules.make(), shapes, bspec,
            compress=compress)
        state = sh.place(steps.init_train_state(
            common.make_generator(SEED, dev), cfg, ocfg, compress=compress),
            ssh)
        if compress:
            out["wire_bytes"] = compress_lib.compressed_wire_bytes(
                state["params"])
            out["f32_bytes"] = 4 * sum(
                int(p.numel()) for p in model.leaves(state["params"]))
        losses, walls = [], []
        for i in range(LM_SHARD_STEPS):
            batch = sh.place(lm_train_batch(cfg, dev, SEED + i), bsh)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            walls.append((time.perf_counter() - t0) * 1e3)
        require(all(np.isfinite(losses)),
                f"compress={compress}: losses {losses}")
        out["compressed" if compress else "plain"] = {
            "losses": losses, "step_ms": walls,
            "step_ms_median": float(np.median(walls[1:]))}
        del state
        torch.cuda.empty_cache()
    gap = abs(out["compressed"]["losses"][-1] - out["plain"]["losses"][-1])
    require(gap < LM_SHARD_LOSS_TOL, f"compressed against plain: the last "
            f"losses {gap:.4f} apart")
    out["last_loss_gap"] = gap
    return out


def lm_shard_dtensor(dev, mesh) -> dict:
    """``jit_train_step`` for LM_FULL[0] at full width on the one-rank
    (data 1, model 1) mesh, LM_DTENSOR_STEPS steps from one seeded state on
    the same batches, the state's leaves as plain tensors (what stands in
    for them on one rank) and then as DTensors: the losses within
    LM_RESUME_RTOL, step ms (host clock until the loss is on the host,
    median of steps 2..) and peak GB each: DTensor's host cost on the
    card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import common
    from repro_torch.sharding import specs as sh
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import schedule as sched
    from repro_torch.train import steps

    cfg = get_config(LM_FULL[0])
    ocfg = opt_lib.AdamWConfig(eight_bit=cfg.opt_8bit)
    scfg = sched.ScheduleConfig(peak_lr=3e-4, warmup_steps=2,
                                total_steps=LM_DTENSOR_STEPS)
    shapes = {n: torch.empty((LM_TRAIN_BATCH, LM_TRAIN_SEQ),
                             dtype=torch.int32, device="meta")
              for n in ("tokens", "labels")}
    bspec = {"tokens": ("batch", None), "labels": ("batch", None)}
    step, _, ssh, bsh = steps.jit_train_step(
        cfg, ocfg, scfg, mesh, sh.Rules.make(), shapes, bspec)
    out = {}
    for dtensor in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state = sh.place(steps.init_train_state(
            common.make_generator(SEED, dev), cfg, ocfg), ssh, dtensor)
        losses, walls = [], []
        for i in range(LM_DTENSOR_STEPS):
            batch = sh.place(lm_train_batch(cfg, dev, SEED + i), bsh, dtensor)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            walls.append((time.perf_counter() - t0) * 1e3)
        require(all(np.isfinite(losses)),
                f"dtensor={dtensor}: losses {losses}")
        out["dtensor" if dtensor else "plain"] = {
            "losses": losses, "step_ms": walls,
            "step_ms_median": float(np.median(walls[1:])),
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
        del state, batch, m
    got = np.asarray(out["dtensor"]["losses"])
    want = np.asarray(out["plain"]["losses"])
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    require(rel <= LM_RESUME_RTOL, f"{LM_FULL[0]} with DTensor leaves: "
            f"losses {got.tolist()} against {want.tolist()}")
    out["losses_max_rel_err"] = rel
    out["losses_bitwise"] = bool(np.array_equal(got, want))
    torch.cuda.empty_cache()
    return out


def dryrun_runs(out_dir: Path, children: list) -> dict:
    """``python -m repro_torch.launch.dryrun`` for each DRYRUN_CELLS cell,
    one subprocess after another, on a thread from the kernel build on:
    fake CUDA tensors over a fake process group, no card (nor its
    memory).  → {key: {"rc", "wall_s", "record", "stderr"}}."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = {}
    for key, (arch, shape, extra) in DRYRUN_CELLS.items():
        where = out_dir / key
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--device", DRYRUN_DEVICE, "--out",
             str(where), *extra], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            preexec_fn=lambda: os.nice(DRYRUN_NICE))
        children.append(proc)
        try:
            _, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        files = list(where.glob("*.json"))
        out[key] = {"rc": proc.returncode,
                    "wall_s": time.perf_counter() - t0,
                    "record": (json.loads(files[0].read_text())
                               if len(files) == 1 else None),
                    "stderr": err[-2000:]}
    return out


def dryrun_check(dev) -> dict:
    """DRYRUN_CELLS["check"]'s cell for real: its published widths in its
    dtypes, params drawn on the card and zeroed caches, placed as
    DTensors by ``fitted_shardings`` on a one-rank (1, 1) NCCL mesh under
    the shape's rules (the dry-run's layout), one ``serve_step``; → its
    peak above the memory allocated before the arguments were made."""
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.shapes import rules_for_shape
    from repro_torch.models import common, model
    from repro_torch.sharding import specs as sh
    from repro_torch.train import steps

    arch, shape_name, _ = DRYRUN_CELLS["check"]
    cfg, shape = get_config(arch), SHAPES[shape_name]
    b = shape.global_batch
    mesh = make_smoke_mesh(1, 1, device=dev)
    rules = rules_for_shape(shape)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()

    def placed(tree, specs):
        return sh.place(tree, sh.fitted_shardings(tree, specs, mesh, rules),
                        dtensor=True)

    params = placed(*model.init_model(common.make_generator(SEED, dev), cfg))
    caches = placed(*model.init_caches(cfg, b, shape.seq_len, dev))
    token = placed({"t": torch.randint(
        0, cfg.vocab, (b, 1), device=dev, dtype=torch.int32,
        generator=common.make_generator(SEED + 1, dev))},
        {"t": ("batch", None)})["t"]
    args_gb = (torch.cuda.memory_allocated() - base) / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with sh.use_mesh(mesh, rules):
        nxt, logits, caches = steps.serve_step(params, caches, token,
                                               shape.seq_len - 1, cfg)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    logits = sh.full(logits)
    require(tuple(logits.shape) == (b, cfg.vocab)
            and bool(torch.isfinite(logits).all())
            and tuple(sh.full(nxt).shape) == (b, 1),
            f"{arch} decode on the card: logits {tuple(logits.shape)}")
    del params, caches, token, nxt, logits
    torch.cuda.empty_cache()
    return {"arch": arch, "shape": shape_name, "batch": b,
            "peak_bytes": int(peak), "args_gb": args_gb, "step_s": step_s}


def dryrun_phase(ctx, counted) -> dict:
    """The dry-run tier: the DRYRUN_CELLS records made on the host
    (``ctx["dryrun_job"]``, from ``dryrun_runs``) and, in this process over
    a one-rank NCCL group made here (and destroyed at the end),
    ``dryrun_check``: the measured peak of a real decode step against the
    dry-run's prediction for the same cell on a (1, 1) mesh (argument plus
    temp bytes), within DRYRUN_PEAK_RATIO.  Each record exits 0 with a
    finite per-device peak; the EP MoE's cost variants show its
    all-to-all.  Launches none of the repo's kernels."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group

    dev = ctx["dev"]
    require(not dist.is_initialized(), "a process group exists already")
    init_process_group(dev)
    out = {}
    try:
        counted("dryrun", lambda: out.update(check=dryrun_check(dev)))
    finally:
        dist.destroy_process_group()
    require(not any(ctx["path_launches"]["dryrun"].values()),
            f"the dry-run phase launched a kernel: "
            f"{ctx['path_launches']['dryrun']}")
    t0 = time.perf_counter()
    runs = ctx["dryrun_job"].result(timeout=3 * DRYRUN_TIMEOUT_S)
    out["wait_s"] = time.perf_counter() - t0
    for key, r in runs.items():
        require(r["rc"] == 0 and r["record"] is not None,
                f"dry-run {DRYRUN_CELLS[key]}: exit {r['rc']}: "
                f"{r['stderr']}")
    rec = {k: r["record"] for k, r in runs.items()}
    peaks = {"decode": rec["decode"]["peak_bytes"],
             "moe_cost": rec["moe_cost"]["cost_terms"]["peak_bytes_1g"],
             "check": rec["check"]["peak_bytes"]}
    require(all(np.isfinite(v) and v > 0 for v in peaks.values()),
            f"dry-run peaks {peaks}")
    a2a = rec["moe_cost"]["cost_terms"]["collectives_1g"]["all-to-all"]
    require(a2a["count"] > 0 and a2a["bytes"] > 0,
            f"the EP MoE's cost variant shows no all-to-all: {a2a}")
    predicted = peaks["check"]
    ratio = out["check"]["peak_bytes"] / predicted
    lo, hi = DRYRUN_PEAK_RATIO
    require(lo <= ratio <= hi, f"{DRYRUN_CELLS['check'][:2]}: the card's "
            f"peak {out['check']['peak_bytes']} B against the dry-run's "
            f"{predicted} B ({ratio:.4f}x)")
    out.update(predicted_peak_bytes=predicted, measured_over_predicted=ratio,
               peaks=peaks, ep_all_to_all_1g=a2a,
               walls_s={k: r["wall_s"] for k, r in runs.items()},
               records={k: {n: v[n] for n in (
                   "arch", "shape", "mesh", "chips", "memory", "peak_bytes",
                   "cost_scanned", "collectives_scanned", "compile_s",
                   "cost_terms", "model_flops", "torch_version") if n in v}
                   for k, v in rec.items()})
    log(f"dry-run: {DRYRUN_CELLS['check'][0]} x {DRYRUN_CELLS['check'][1]}"
        f" on the card {out['check']['peak_bytes']} B peak against the "
        f"dry-run's {predicted} B on (1, 1) ({ratio:.4f}x); records "
        f"{ {k: r['wall_s'] for k, r in runs.items()} } s")
    return out


def lm_shard_phase(ctx, counted) -> dict:
    """The sharding path on the card, in this process, over a one-rank
    NCCL process group made here (and destroyed at the end): the EP MoE
    layer of LM_SHARD_EP and the ff-sharded one of LM_SHARD_FF at their
    published widths against ``_moe_local`` (``lm_shard_moe``) on a
    (data 1, model 1) mesh, and the compressed train step of
    LM_SHARD_COMPRESS against the plain mesh step on (pod 1, data 1,
    model 1) (``lm_shard_compress``).  It launches none of the repo's
    kernels."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_smoke_mesh

    dev = ctx["dev"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    require(not dist.is_initialized(), "a process group exists already")
    init_process_group(dev)
    require(dist.get_backend() == "nccl",
            f"the group's backend is {dist.get_backend()}, not nccl")
    out = {}
    try:
        def path():
            mesh = make_smoke_mesh(1, 1, device=dev)
            for key, arch in (("ep", LM_SHARD_EP), ("ff", LM_SHARD_FF)):
                out[key] = lm_shard_moe(arch, dev, mesh)
            out["compress"] = lm_shard_compress(
                dev, make_smoke_mesh(1, 1, pod=1, device=dev))
            out["dtensor"] = r = lm_shard_dtensor(dev, mesh)
            log(f"lm train {LM_FULL[0]} with DTensor leaves: step "
                f"{r['dtensor']['step_ms_median']:.3f} ms against "
                f"{r['plain']['step_ms_median']:.3f} ms plain, peak "
                f"{r['dtensor']['peak_gb']:.3f} GB; losses bitwise "
                f"{r['losses_bitwise']}")

        counted("lm_shard", path)
    finally:
        dist.destroy_process_group()
    require(not any(ctx["path_launches"]["lm_shard"].values()),
            f"the sharding path launched a kernel: "
            f"{ctx['path_launches']['lm_shard']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=FULL_ROWS,
                    help="row count of the table (cut only if forced)")
    args = ap.parse_args(argv)

    import torch

    dev = require_cuda()
    sys.path.insert(0, str(ROOT / "src"))
    # the finer layout and the baselines are built in other processes while
    # the rest runs
    children: list = []  # the train CLIs started in the background
    try:
        with multiprocessing.get_context("spawn").Pool(2) as pool, \
                tempfile.TemporaryDirectory(prefix="qd-store-") as store_root:
            fine_job = pool.apply_async(fine_layout, (SEED,))
            return run(args, dev, torch, pool, fine_job, Path(store_root),
                       children)
    finally:
        for proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run(args, dev, torch, pool, fine_job, store_root, children) -> int:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import rewards
    from repro_torch.core.greedy import GreedyConfig, build_greedy
    from repro_torch.core.qdtree import FrozenQdTree, IncrementalTightener
    from repro_torch.data.datagen import make_tpch_like
    from repro_torch.data.workload import make_tpch_workload
    from repro_torch.engine import LayoutEngine, backends as be
    from repro_torch.engine import plan as tplan
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_ingest as fk
    from repro_torch.kernels import query_intersect as qk
    from repro_torch.kernels import route_records as rk
    from repro_torch.kernels.ref import fused_ingest_ref

    t_start = time.perf_counter()
    workers = max(os.cpu_count() or 1, 1)
    require(torch.backends.cuda.matmul.allow_tf32 is False,
            "float32 matmuls must not run in TF32")
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device {kind}; {smi}")

    # -- build ----------------------------------------------------------------
    t0 = time.perf_counter()
    per_kernel = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"kernels built and loaded in {build_s:.1f}s")
    # the LM training path's CLI runs (lm_train_cli_runs) use the card
    # while the host work below leaves it idle; the main path waits for
    # them after the finer layout, and lm_train_phase reads them
    lm_pool = ThreadPoolExecutor(1)
    lm_job = lm_pool.submit(lm_train_cli_runs, Path(store_root) / "lm-ckpt",
                            children)
    lm_pool.shutdown(wait=False)
    # the dry-run's records, made on the host (no card) beside everything
    # up to dryrun_phase, which reads them
    dry_pool = ThreadPoolExecutor(1)
    dryrun_job = dry_pool.submit(dryrun_runs, Path(store_root) / "dryrun",
                                 children)
    dry_pool.shutdown(wait=False)

    # -- small random trees: every kernel (both fused kernels) vs plain, and
    # the running fold over uneven batches --------------------------------
    for seed in (1, 2):
        tree, recs, work = random_case(seed)
        rec = torch.from_numpy(recs).to(dev)
        tree.tighten(recs, tree.route(recs))
        ctx = f"random tree {seed}"
        compare_kernels(tree, rec, work.tensorize(tree.cuts), dev, ctx)
        running_fold(tree, rec, recs, [0, 1, 777, 20_000, 20_001, 50_000],
                     dev, ctx, FUSED_VARIANTS, workers)
    torch.cuda.synchronize()
    log("small random trees: every kernel equals its plain version; the "
        "running fold equals the plain version and the numpy oracle")

    # -- data, workload, layout ---------------------------------------------
    n_rows = args.rows
    if n_rows != FULL_ROWS:
        log(f"CUT: {n_rows} rows instead of {FULL_ROWS}")
    t0 = time.perf_counter()
    schema, records = make_tpch_like(n_rows, seed=SEED)
    work, _ = make_tpch_workload(schema, n_per_template=10, seed=SEED)
    cuts = work.candidate_cuts()
    wt = work.tensorize(cuts)
    datagen_s = time.perf_counter() - t0
    sample = records[::SAMPLE_EVERY]
    t0 = time.perf_counter()
    tree = build_greedy(sample, work, cuts,
                        GreedyConfig(min_block=MIN_BLOCK)).freeze()
    greedy_s = time.perf_counter() - t0
    log(f"{n_rows} rows, {len(work)} queries / {wt.n_conjuncts} conjuncts, "
        f"{cuts.n_cuts} cuts ({cuts.n_adv} adv), greedy on {sample.shape[0]}"
        f" rows in {greedy_s:.1f}s: {tree.n_leaves} leaves, {tree.n_nodes} "
        f"nodes, depth {tree.depth}")
    base_job = pool.apply_async(baseline_layouts,
                                (sample, SEED, tree.n_leaves))
    untightened = tree.to_arrays()
    # the numpy oracle of the whole stream on host threads, beside the
    # waits and the main path below (its check comes after them)
    oracle_pool = ThreadPoolExecutor(1)
    oracle_job = oracle_pool.submit(timed, oracle_partial,
                                    FrozenQdTree.from_arrays(untightened),
                                    records, workers)
    oracle_pool.shutdown(wait=False)
    t0 = time.perf_counter()
    fine_arrays = fine_job.get(timeout=FINE_TIMEOUT_S)
    fine_wait_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm_cli_runs = lm_job.result(timeout=LM_CLI_WAIT_S)
    lm_cli_wait_s = time.perf_counter() - t0
    log(f"the train CLI's runs done (waited {lm_cli_wait_s:.1f}s for them)")
    fine = FrozenQdTree.from_arrays(fine_arrays)
    log(f"finer layout: {fine.n_leaves} leaves, depth {fine.depth} (waited "
        f"{fine_wait_s:.1f}s for it)")
    rec_dev = torch.from_numpy(records).to(dev)
    slices = [rec_dev[s:s + BATCH] for s in range(0, n_rows, BATCH)]
    sizes = {s.shape[0] for s in slices}
    torch.cuda.synchronize()

    # -- the main path, counted: each path from 0 just before it ------------
    engine = LayoutEngine(tree)  # backend "torch" on the GPU
    fine_engine = LayoutEngine(fine)
    require(engine.device == dev, f"engine on {engine.device}")
    path_launches = {}

    def counted(path, fn):
        _build.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        path_launches[path] = _build.launch_counts()
        return out

    def ingest_path():
        engine.warm_ingest(sizes)
        rep = engine.ingest(slices)
        require(rep.builds == {},
                f"plans built during the warm ingest: {rep.builds}")
        fine_engine.warm_ingest(sizes)
        return rep, fine_engine.ingest(slices), engine.fused_step(slices[0])

    def query_path():
        engine.route_queries(work)
        st = engine.skip_stats(rec_dev, work)
        ls = engine.route_queries(work)  # against the tightened descriptions
        return st, ls, [engine.route_query(q)
                        for q in work.queries[:ROUTE_QUERY_N]]

    report, fine_report, (fused_bids, _) = counted("ingest", ingest_path)
    route_bids, fine_route_bids = counted("route", lambda: (
        engine.route(slices[0]), fine_engine.route(slices[0])))
    stats, lists, one = counted("query", query_path)
    launches = {k: sum(c[k] for c in path_launches.values())
                for k in _build.LAUNCH_NAMES}
    log(f"main path launches by path: {path_launches}")
    for name, n in launches.items():
        if name in OFF_PATH:
            require(n == 0, f"kernel {name} launched on the main path")
        else:
            require(n > 0, f"kernel {name} never launched on the main path")
    # one launch of each layout's planned route kernel: the shared one on
    # the main layout, the prefix one on the finer layout (whose nodes
    # would leave the shared kernel two blocks of 28 warps)
    planned = [rk.ROUTE_KERNELS[rk.descend_plan(
        t.n_nodes, schema.ndims, rk.optin_bytes(dev.index)).kernel]
        for t in (tree, fine)]
    require(planned == ["route_descend_shared", "route_descend_prefix"],
            f"route plans {planned}")
    require(path_launches["route"] == {
        k: 2 if k == "route_descend" else planned.count(k)
        for k in path_launches["route"]
    }, f"two route calls launched {path_launches['route']}; expected one "
       f"of {planned} each and nothing else")

    # -- what came out is right ----------------------------------------------
    require(np.array_equal(route_bids, fused_bids),
            "route and fused_step disagree on block ids")
    for ctx, t, got in (("main layout", tree, route_bids),
                        ("finer layout", fine, fine_route_bids)):
        o = route_ops(t, dev)
        two = rk.locate_leaf(rk.eval_cuts(slices[0], o), o).cpu().numpy()
        require(np.array_equal(got, two),
                f"{ctx}: route differs from eval_cuts → locate_leaf")
        require(np.array_equal(got, t.route(records[:BATCH])),
                f"{ctx}: route differs from the numpy oracle")
    require(len(lists) == len(work) and stats.n_blocks == tree.n_leaves,
            "query routing shapes")
    for q, bids in enumerate(one):
        require(np.array_equal(bids, lists[q]),
                f"route_query differs from route_queries on query {q}")
    require(int(report.block_sizes.sum()) == n_rows
            and np.array_equal(report.block_sizes, stats.block_sizes),
            "block sizes")
    t0 = time.perf_counter()
    (oracle_bids, part), oracle_s = oracle_job.result()
    oracle_wait_s = time.perf_counter() - t0
    oracle_tree = FrozenQdTree.from_arrays(untightened)
    tightener = IncrementalTightener(oracle_tree)
    tightener.merge(part)
    tightener.apply()
    for f in ("leaf_lo", "leaf_hi", "leaf_cat", "leaf_adv", "block_sizes"):
        require(np.array_equal(getattr(oracle_tree, f), getattr(tree, f)),
                f"whole-stream {f} differs from the numpy oracle")
    log(f"whole stream: tightened descriptions equal the numpy oracle's "
        f"({oracle_s:.1f}s on {workers} host threads from the greedy "
        f"build on; waited {oracle_wait_s:.1f}s for it)")
    plain_fine = FrozenQdTree.from_arrays(fine_arrays)
    plain_acc = fk.IngestAccumulator(route_ops(plain_fine, dev))
    for s in slices:
        fk.fused_ingest_plain(s, plain_acc, bids=False)
    tightener = IncrementalTightener(plain_fine)
    tightener.merge(plain_acc.partial(plain_fine))
    tightener.apply()
    for f in ("leaf_lo", "leaf_hi", "leaf_cat", "leaf_adv", "block_sizes"):
        require(np.array_equal(getattr(plain_fine, f), getattr(fine, f)),
                f"finer layout: whole-stream {f} differs from the plain "
                f"torch path")
    log("finer layout: tightened descriptions equal the plain torch path's")
    o_bids, o_part = engine.fused_step(rec_dev[:ORACLE_ROWS])
    w_bids, w_part = fused_ingest_ref(tree, records[:ORACLE_ROWS])
    require(np.array_equal(o_bids, w_bids), "oracle rows: block ids")
    for f in ("counts", "lo", "hi", "cat", "adv"):
        require(np.array_equal(getattr(o_part, f), getattr(w_part, f)),
                f"oracle rows: {f} differs from fused_ingest_ref")
    numpy_be = be.get_backend("numpy")
    n_hits, n_scanned = numpy_be.query_intersect(
        tree, tplan.PlanCache(), wt, dev)
    require(np.array_equal(stats.query_hits, n_hits), "query hits vs numpy")
    require(np.array_equal(stats.conj_scanned, n_scanned),
            "per-conjunct scan counts vs numpy")
    require(0.0 < stats.scanned_fraction <= 1.0, "scanned fraction")
    lower = rewards.selectivity_lower_bound(sample, work)
    log(f"scanned fraction {stats.scanned_fraction:.6f}; selectivity lower "
        f"bound {lower:.6f} (on the 1% sample)")

    # -- latencies: warm calls on the host clock; a warm engine builds no plan
    warm = tplan.build_counts()
    route_ms = host_ms(lambda: engine.route(slices[0]), LAT_REPS)
    # route's two parts: the ids' copy back (here) and its one kernel, from
    # a trace of engine.route calls that also shows no other kernel (taken
    # after the host-clock latencies, so that no profiler run precedes them)
    ids = rk.route(slices[0], route_ops(tree, dev))
    torch.cuda.synchronize()
    route_copy_ms = host_ms(lambda: ids.cpu(), LAT_REPS)
    queries_ms = host_ms(lambda: engine.route_queries(work), LAT_REPS)
    query_ms = host_ms(lambda: engine.route_query(work.queries[0]), LAT_REPS)
    route_kernel_ms = traced_kernel_sample(lambda: engine.route(slices[0]),
                                           "route_descend_shared",
                                           LAT_REPS)["ms"]
    engine.fused_step(slices[-1], return_bids=False)
    require(tplan.build_counts() == warm, "a warm engine built a plan")

    # -- ingest: its spread over fresh trees, the device's busy share and
    # copies from a profiler trace, and the fold once an ingest ----------
    def fresh_engine():
        eng = LayoutEngine(FrozenQdTree.from_arrays(untightened))
        eng.warm_ingest(sizes)
        torch.cuda.synchronize()
        return eng

    walls = [fresh_engine().ingest(slices).wall_s
             for _ in range(INGEST_REPS)]
    traced_eng = fresh_engine()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = traced_eng.ingest(slices)
    tr = trace_counts(prof)
    require(tr["fused_kernels"] == len(slices),
            f"the trace shows {tr['fused_kernels']} fused_ingest kernels for "
            f"{len(slices)} batches")
    require(tr["d2h_copies"] == 1,
            f"the traced ingest copied to the host {tr['d2h_copies']} times; "
            f"the aggregates should come back once")
    fold_tree = FrozenQdTree.from_arrays(untightened)
    acc = be.get_backend("torch").accumulator(fold_tree, tplan.PlanCache(),
                                              dev)
    for s in slices:
        acc.fold(s)
    torch.cuda.synchronize()
    single_partial = acc.partial()
    fold_ms = []
    for _ in range(FOLD_REPS):
        t0 = time.perf_counter()
        IncrementalTightener(fold_tree).merge(acc.partial())
        fold_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"ingest walls {walls}; traced {traced.wall_s:.6f}s, {tr}; fold "
        f"once an ingest {fold_ms} ms")

    # -- kernels vs plain at the main path's shapes; the finer layout, too
    # large for shared memory; the running fold over uneven batches -------
    errs = compare_kernels(tree, slices[0], wt, dev, "main path shapes")
    fine_errs = compare_kernels(fine, slices[0], wt, dev, "finer layout",
                                variants=("cluster", "leafwise", "global"))
    fops = route_ops(fine, dev)
    before = _build.launch_counts()
    fk.IngestAccumulator(fops).fold(slices[0])
    after = _build.launch_counts()
    require({k: after[k] - before[k] for k in after}
            == {k: int(k in LEAFWISE_KERNELS) for k in after},
            "the finer layout's aggregates should take the leafwise design")
    try:
        with fk._forced("shared"):
            fk.IngestAccumulator(fops).fold(slices[0])
        refused = False
    except RuntimeError:
        refused = True
    require(refused, "a shared-memory request past the card's limit must "
                     "raise")
    for k in ("fused_ingest_cluster", "fused_ingest_global",
              *LEAFWISE_KERNELS, *rk.ROUTE_KERNELS.values()):
        errs[k] = max(errs[k], fine_errs[k])
    n_run = min(n_rows, 3 * BATCH // 2)
    bounds = sorted({0, 1, 1000, min(BATCH - 3, n_run), n_run})
    running_fold(tree, rec_dev, records, bounds, dev, "main path shapes",
                 FUSED_VARIANTS, workers)
    log("main path shapes: every kernel equals its plain version; running "
        "fold equal to the plain version and the numpy oracle")

    # -- timing ---------------------------------------------------------------
    x = slices[0]
    ops = route_ops(tree, dev)
    leaf, conj, layout = query_args(tree, wt, dev)
    m_mat = rk.eval_cuts(x, ops)
    acc_s = fk.IngestAccumulator(ops)
    with fk._forced("cluster"):  # forced only, on the layout it was made for
        acc_c = fk.IngestAccumulator(fops)
    acc_p, acc_cp = fk.IngestAccumulator(ops), fk.IngestAccumulator(fops)
    acc_gp = fk.IngestAccumulator(fops)
    with fk._forced("global"):  # the old kernel, on the same layouts
        acc_gm, acc_g = fk.IngestAccumulator(ops), fk.IngestAccumulator(fops)
    runs = {
        "eval_cuts": (lambda: rk.eval_cuts(x, ops),
                      lambda: rk.eval_cuts_plain(x, ops)),
        "locate_leaf": (lambda: rk.locate_leaf(m_mat, ops),
                        lambda: rk.locate_leaf_plain(m_mat, ops)),
        # as the ingest folds a batch: no block ids
        "fused_ingest_shared": (
            lambda: acc_s.fold(x),
            lambda: fk.fused_ingest_plain(x, acc_p, bids=False)),
        "fused_ingest_cluster": (
            lambda: acc_c.fold(x),
            lambda: fk.fused_ingest_plain(x, acc_cp, bids=False)),
        "fused_ingest_global": (
            lambda: acc_g.fold(x),
            lambda: fk.fused_ingest_plain(x, acc_gp, bids=False)),
        "query_intersect": (lambda: qk.query_intersect(leaf, conj, layout),
                            lambda: qk.query_intersect_plain(leaf, conj,
                                                             layout)),
    }
    times = {n: (time_ms(k, 20), time_ms(p, 3)) for n, (k, p) in runs.items()}
    # the finer layout's planned design (leafwise) against the cluster
    # kernel and the first draft, forced, in turns (each, then each again
    # in reverse): single calls and stream ms
    fine_turns = {"leafwise": fk.IngestAccumulator(fops), "cluster": acc_c,
                  "global": acc_g}
    fine_times = {v: {"ms": [], "stream_ms": []} for v in fine_turns}
    for v in [*fine_turns, *reversed(fine_turns)]:
        fold = (lambda a=fine_turns[v]: a.fold(x))
        fine_times[v]["ms"].append(time_ms(fold, 20))
        fine_times[v]["stream_ms"].append(stream_ms(fold))
    leafwise_trace = leafwise_stages(fine_turns["leafwise"], x)
    leafwise_plain = leafwise_stage_plain(fine_turns["leafwise"], x)
    # the global kernel on the main layout (the same work as the shared
    # one); the host side of one fold (wrapper and launch, no sync) and
    # the shared kernel's plan
    global_on_main_ms = time_ms(lambda: acc_gm.fold(x), 20)
    # route_descend's kernels on the main and the finer layout, each forced,
    # in turns (each, then each again in reverse): 20 single calls between
    # CUDA events, and back to back (stream_ms); the plain version's time
    route_runs = {}
    for lay, o in (("main", ops), ("fine", fops)):
        for f in ROUTE_FORCED[:3]:
            with rk._forced(*f):
                plan = rk.route_plan(o)
            route_runs[f"{lay} {rk.ROUTE_KERNELS[plan.kernel]}"] = (
                lambda o={**o, "route_plan": plan}: rk.route(x, o))
    route_times = {k: {"ms": [], "stream_ms": []} for k in route_runs}
    for k in [*route_runs, *reversed(route_runs)]:
        route_times[k]["ms"].append(time_ms(route_runs[k], 20))
        route_times[k]["stream_ms"].append(stream_ms(route_runs[k]))
    route_plain_ms = time_ms(lambda: rk.route_plain(x, ops), 3)
    for name in rk.ROUTE_KERNELS.values():
        times[name] = (float(np.median(route_times[f"main {name}"]["ms"])),
                       route_plain_ms)
    route_global_on_main_ms = times["route_descend_global"][0]
    route_fine_ms = float(np.median(route_times[
        f"fine {rk.ROUTE_KERNELS[rk.route_plan(fops).kernel]}"]["ms"]))
    torch.cuda.synchronize()
    fold_host_ms = host_ms(lambda: acc_s.fold(x), FOLD_HOST_REPS)
    torch.cuda.synchronize()
    plan_keys = ("kernel", "warps", "smem_bytes", "most_blocks")
    shared_plan = dict(zip(plan_keys, acc_s._launch))
    # eval_cuts and locate_leaf alone in a trace, at the main path's shapes
    eval_trace = traced_kernel_sample(lambda: rk.eval_cuts(x, ops),
                                      "eval_cuts", LAT_REPS)
    locate_trace = traced_kernel_sample(lambda: rk.locate_leaf(m_mat, ops),
                                        "locate_leaf", LAT_REPS)
    # the query kernel's own device time, without the wrapper's host side
    q_kernel_ms = traced_kernel_sample(
        lambda: qk.query_intersect(leaf, conj, layout), "query_intersect",
        LAT_REPS)["ms"]

    # -- this slice's paths, each counted from 0: the trees past one block's
    # shared memory, sharded ingest, spill, block store, autotune,
    # baselines -------------------------------------------------------------
    ctx = {
        "dev": dev, "records": records, "rec_dev": rec_dev, "slices": slices,
        "sizes": sizes, "n_rows": n_rows, "untightened": untightened,
        "oracle_tree": oracle_tree, "oracle_bids": oracle_bids,
        "oracle_partial": part, "single_partial": single_partial,
        "workers": workers, "path_launches": path_launches,
        "worker_launches": [], "work": work, "wt": wt, "sample": sample,
        "tree": tree, "children": children, "lm_cli": lm_cli_runs,
    }
    t0 = time.perf_counter()
    big = big_tree_phase(ctx, cuts, x, counted)
    phase_s = {"big_trees": time.perf_counter() - t0}
    t0 = time.perf_counter()
    shards = shard_phase(ctx, counted)
    phase_s["shard"] = time.perf_counter() - t0
    # the spill and the store on a prefix of the table, against the numpy
    # oracle of that prefix (PERF.md §4: the run's length)
    t0 = time.perf_counter()
    n_pre = min(n_rows, STORE_ROWS)
    pre_tree = FrozenQdTree.from_arrays(untightened)
    pre_part = oracle_partial(pre_tree, records[:n_pre], workers)[1]
    tightener = IncrementalTightener(pre_tree)
    tightener.merge(pre_part)
    tightener.apply()
    pre_slices = [rec_dev[s:min(s + BATCH, n_pre)]
                  for s in range(0, n_pre, BATCH)]
    pctx = {**ctx, "records": records[:n_pre], "n_rows": n_pre,
            "slices": pre_slices, "sizes": {x.shape[0] for x in pre_slices},
            "oracle_bids": oracle_bids[:n_pre], "oracle_tree": pre_tree}
    spill_buf, spill_tree, spill = spill_phase(pctx, counted)
    spill["rows"] = n_pre
    phase_s["spill"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = store_phase(pctx, counted, spill_buf, spill_tree, store_root)
    del spill_buf
    phase_s["store"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tuned = autotune_phase(ctx, counted)
    phase_s["autotune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    layouts = base_job.get(timeout=BASELINE_TIMEOUT_S)
    # the CPU halves of the LM training path's reduced-arch checks, in the
    # pool (now idle) while the phases below run
    from repro_torch.configs import ARCHS as lm_archs

    ctx["lm_host_jobs"] = {a: pool.apply_async(lm_train_host, (a,))
                           for a in sorted(lm_archs)}
    phase_s["baseline_wait"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    baselines = baseline_phase(ctx, counted, layouts)
    phase_s["baseline"] = time.perf_counter() - t0
    # -- the layout lifecycle: WOODBLOCK and the service layers, each path
    # counted from 0 ---------------------------------------------------------
    ctx["cuts"] = cuts
    ctx["greedy_scanned_sample"] = baselines["qdtree"]["scanned_fraction"]
    # both CLIs run in their own processes beside the phases up to
    # cli_phase, which reads them (their launches are their own)
    cli_started = cli_start(ctx)
    # the examples and qdlint, in their lanes beside the phases up to
    # examples_phase, which reads them
    ex_pool = ThreadPoolExecutor(1)
    ctx["examples_job"] = ex_pool.submit(examples_runs, children)
    ex_pool.shutdown(wait=False)
    t0 = time.perf_counter()
    woodblock = woodblock_phase(ctx, counted)
    phase_s["woodblock"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    service = service_phase(ctx, counted)
    phase_s["service"] = time.perf_counter() - t0
    # -- the serving tier, the pipeline, the fleet coordinator and the
    # CLIs, each path counted from 0 ----------------------------------------
    t0 = time.perf_counter()
    serve = serve_phase(ctx, counted)
    phase_s["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pipeline = pipeline_phase(pctx, counted, store_root)
    phase_s["pipeline"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet = coordinator_phase(pctx, counted)
    phase_s["coordinator"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli = cli_phase(ctx, cli_started)
    phase_s["cli"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    examples = examples_phase(ctx)
    phase_s["examples"] = time.perf_counter() - t0
    # -- the LM serving path, counted from 0 ---------------------------------
    t0 = time.perf_counter()
    lm = lm_serve_phase(ctx, counted)
    phase_s["lm_serve"] = time.perf_counter() - t0
    # -- the LM training path, counted from 0 --------------------------------
    t0 = time.perf_counter()
    lm_train = lm_train_phase(ctx, counted)
    phase_s["lm_train"] = time.perf_counter() - t0
    # -- the sharding path, counted from 0 -------------------------------------
    t0 = time.perf_counter()
    lm_shard = lm_shard_phase(ctx, counted)
    phase_s["lm_shard"] = time.perf_counter() - t0
    # -- the dry-run tier, counted from 0 -------------------------------------
    t0 = time.perf_counter()
    ctx["dryrun_job"] = dryrun_job
    dryrun = dryrun_phase(ctx, counted)
    phase_s["dryrun"] = time.perf_counter() - t0
    # every path's launches, the process shards' (made in their workers)
    # included
    launches = {k: sum(c[k] for c in path_launches.values())
                + sum(w.get(k, 0) for w in ctx["worker_launches"])
                for k in _build.LAUNCH_NAMES}
    log(f"launches by path: {path_launches}; in other processes (process "
        f"shards, the CLIs): "
        f"{ctx['worker_launches']}")
    # eval_cuts is back on a counted path: WOODBLOCK's env; locate_leaf
    # stays off every path
    require(all(c["locate_leaf"] == 0 for c in path_launches.values()),
            "locate_leaf launched on a counted path")
    require(all(c["eval_cuts"] == 0 for p, c in path_launches.items()
                if not p.startswith("woodblock")),
            "eval_cuts launched outside WOODBLOCK's env")

    # -- bounds from this run's inputs ---------------------------------------
    m, d = x.shape
    C, L, bits = cuts.n_cuts, tree.n_leaves, int(ops["bits"])
    nodes = 4 * 4 * tree.n_nodes
    path = int(leaf_depths(tree)[route_bids].sum())  # cuts read on descent
    # the sectors of the predicate matrix the rows' paths read
    sectors = path_sectors(tree, route_bids)
    nq = wt.n_conjuncts
    n_num = int(layout["num_dims"].shape[0])
    n_ent, aw = int(layout["seg_word"].shape[0]), int(layout["aw"])
    kl, kc = int(leaf["desc"].shape[1]), int(conj["desc"].shape[1])
    bounds_ms = {
        "eval_cuts": bound(m * d * 4 + eval_table_bytes(ops) + m * C,
                           m * C),
        "locate_leaf": bound(32 * sectors + nodes + m * 4, path),
        **dict.fromkeys(rk.ROUTE_KERNELS.values(),
                        route_bound(tree, ops, route_bids, m, d)),
        "fused_ingest_shared": fused_bound(tree, ops, route_bids, m, d),
        "fused_ingest_cluster": fused_bound(fine, fops, fine_route_bids, m,
                                            d),
        "fused_ingest_global": fused_bound(fine, fops, fine_route_bids, m, d),
        "query_intersect": bound(
            4 * (L * kl + nq * kc) + 8 * L + L * nq + 8 * nq,
            L * nq * (2 * n_num + n_ent + 4 * aw) + L * nq,
        ),
    }
    # eval_cuts at the shape its counted path (WOODBLOCK's env) gives it
    wb_eval = woodblock["eval_cuts"]
    eval_cuts_batch = {"ms": times["eval_cuts"][0],
                       "trace_ms": eval_trace["ms"],
                       "trace_events": eval_trace["events"],
                       "plain_ms": times["eval_cuts"][1],
                       "bound_ms": bounds_ms["eval_cuts"][0],
                       "max_abs_err": errs["eval_cuts"]}
    times["eval_cuts"] = (wb_eval["ms"], wb_eval["plain_ms"])
    bounds_ms["eval_cuts"] = (wb_eval["bound_ms"], wb_eval["bound_by"])
    errs["eval_cuts"] = wb_eval["max_abs_err"]
    # the leafwise design's rows, a kernel each, on the finer layout (the
    # plan's design there): its device ms from a trace (one wrapper call
    # launches the four), its stage's plain version and the stage's own
    # bound on the same inputs; the design's whole-fold times are the
    # metrics' fused_fine_times and big_trees
    bounds_ms.update(leafwise_stage_bounds(fine, fops, fine_route_bids, m,
                                           d))
    for name in LEAFWISE_KERNELS:
        times[name] = (leafwise_trace[name]["ms"],
                       leafwise_plain[name]["plain_ms"])
        errs[name] = max(errs[name], leafwise_plain[name]["max_abs_err"],
                         *(r["max_abs_err"] for r in big.values()))
    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        ms, plain_ms = times[name]
        bound_ms, bound_by = bounds_ms[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": (leafwise_plain[name]["library_ms"]
                           if name in LEAFWISE_KERNELS else None),
        })
        if name in rk.ROUTE_KERNELS.values():  # and on the big trees
            kernels[-1]["stream_ms"] = float(np.median(
                route_times[f"main {name}"]["stream_ms"]))
            kernels[-1]["by_leaves"] = {
                n: big_route_row(big[n]["route"], name)
                for n in BIG_ROUTE_TREES}
        if name in LEAFWISE_KERNELS:  # its own numbers on the big trees
            kernels[-1]["ms_from"] = "trace"
            kernels[-1]["trace_events"] = leafwise_trace[name]["events"]
            kernels[-1]["by_leaves"] = {
                n: {**big[n]["stages"][name],
                    "launches": big[n]["launches"].get(name, 0),
                    "stage_err": big[n]["stage_err"]} for n in BIG_TREES}
        elif name in ("fused_ingest_global", "fused_ingest_cluster"):
            variant = name[len("fused_ingest_"):]
            kernels[-1]["by_leaves"] = {
                n: big_fused_row(big[n], variant, name) for n in BIG_TREES}
            kernels[-1]["stream_ms"] = float(np.median(
                fine_times[variant]["stream_ms"]))  # on the finer layout
    n_batches = len(slices)
    fold_med = float(np.median(fold_ms))
    metrics = {
        "rows": n_rows, "batch": BATCH, "batches": n_batches,
        "queries": len(work), "conjuncts": nq, "cuts": C, "adv_cuts":
        cuts.n_adv, "cat_bits": bits, "leaves": L, "nodes": tree.n_nodes,
        "depth": tree.depth, "fine_leaves": fine.n_leaves,
        "fine_depth": fine.depth,
        "ingest_records_per_s": n_rows / float(np.median(walls)),
        "ingest_s": spread(walls),
        "ingest_ms_per_batch": float(np.median(walls)) * 1e3 / n_batches,
        "ingest_first_s": report.wall_s,
        "fine_ingest_first_s": fine_report.wall_s,
        # one ingest under torch.profiler: the union of device activity
        # over that ingest's wall
        "ingest_traced_s": traced.wall_s,
        "ingest_device_busy_ms": tr["busy_ms"],
        "ingest_fused_kernel_ms": tr["fused_kernel_ms"],
        "ingest_fused_kernel_ms_per_batch": tr["fused_kernel_ms"] / n_batches,
        "ingest_d2h_copies": tr["d2h_copies"],
        "ingest_device_busy_share": tr["busy_ms"] / (traced.wall_s * 1e3),
        # the running accumulator's one copy back + merge, once an ingest;
        # and that over the batches, beside the per-batch fold it replaced
        "fold_ms_per_ingest": spread(fold_ms),
        "fold_ms_per_ingest_over_batches": fold_med / n_batches,
        "fused_global_on_main_layout_ms": global_on_main_ms,
        "route_global_on_main_layout_ms": route_global_on_main_ms,
        "route_times": route_times,
        "route_descend_fine_ms": route_fine_ms,
        "eval_cuts_batch": eval_cuts_batch,
        "locate_leaf_trace": locate_trace,
        "locate_leaf_path_sectors": sectors,
        "eval_cuts_plan": dict(zip(plan_keys, rk.eval_cuts_plan(ops))),
        "locate_leaf_plan": dict(zip(plan_keys, rk.locate_leaf_plan(ops))),
        "fused_fold_host_ms": fold_host_ms,
        "fused_shared_plan": shared_plan,
        # the cluster kernel's plan on the finer layout (forced), and the trees past
        # one block grown from the sample
        "fused_cluster_plan": acc_c._launch._asdict(),
        "fused_fine_plan": fine_turns["leafwise"]._launch._asdict(),
        "fused_fine_times": fine_times,
        "fused_leafwise_trace": leafwise_trace,
        "fused_leafwise_plain": leafwise_plain,
        "big_trees": big,
        "query_intersect_kernel_ms": q_kernel_ms,
        "route_ms_per_batch": route_ms,
        # its kernel alone (trace of engine.route calls) and the ids' copy
        # back (host clock around .cpu() of a batch's ids)
        "route_kernel_ms": route_kernel_ms,
        "route_copy_ms": route_copy_ms,
        "route_plan": rk.route_plan(ops)._asdict(),
        "route_plan_fine": rk.route_plan(fops)._asdict(),
        "route_queries_ms": queries_ms,
        "route_query_ms": query_ms,
        "scanned_fraction": stats.scanned_fraction,
        "selectivity_lower_bound_sample": lower,
        "build_s": build_s, "build_s_per_kernel": per_kernel,
        "datagen_s": datagen_s, "greedy_s": greedy_s,
        "fine_wait_s": fine_wait_s, "lm_cli_wait_s": lm_cli_wait_s,
        "oracle_s": oracle_s, "oracle_wait_s": oracle_wait_s,
        "host_threads": workers,
        "sharded_ingest": shards, "spill_ingest": spill,
        "block_store": store, "autotune": tuned, "baselines": baselines,
        "woodblock": woodblock, "service": service, "serve": serve,
        "pipeline": pipeline, "coordinator": fleet, "cli": cli,
        "examples": examples, "lm_serve": lm, "lm_train": lm_train, "lm_shard": lm_shard,
        "dryrun": dryrun, "phase_s": phase_s,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "total_s": time.perf_counter() - t_start,
    }
    print(smi)
    print(f"build seconds: {build_s:.3f}")
    print(f"fold once an ingest: {fold_med:.6f} ms "
          f"({fold_med / n_batches:.6f} ms over each of {n_batches} batches)")
    for executor in ("thread", "process"):
        for k, r in shards[executor].items():
            w, mg = r["wall_ms"], r["merge_ms"]
            print(f"sharded ingest, {executor} k={k}: wall {w['median']:.3f} "
                  f"ms "
                  f"(min {w['min']:.3f}, max {w['max']:.3f}), merge "
                  f"{mg['median']:.3f} ms, {r['batches']} batches, launches "
                  f"{r.get('launches') or r.get('worker_launches')}")
    print(f"sharded ingest: faster at k=4 {shards['faster_at_k4']}; default "
          f"on a GPU {shards['default_on_gpu']}")
    print(f"spill ingest: {spill['wall_ms']} ms; traced split "
          f"{spill['traced_split_ms']}")
    print(f"block store: {store['rows']} rows written in "
          f"{store['write_s']:.3f} s; scans {store['scans']}")
    for row in tuned["rows"]:
        print(f"autotune candidate: {row}")
    print(f"autotune: chose {tuned['chosen']} (analytic plan "
          f"{tuned['analytic_plan']}); ingest ms {tuned['ingest_ms']}; one "
          f"fold ms {tuned['fold_ms']}")
    print("baselines on the sample, scanned fraction: " + ", ".join(
        f"{k} {v['scanned_fraction']:.6f} ({v['blocks']} blocks)"
        for k, v in baselines.items())
        + f"; qd-tree over the whole table {stats.scanned_fraction:.6f}")
    wb = woodblock
    print(f"woodblock: {wb['episodes']} episodes in {wb['build_s']:.3f} s "
          f"({wb['episodes_per_s']:.4f}/s); policy step "
          f"{wb['policy_step_ms']['median']:.3f} ms a level "
          f"({wb['policy_steps']} levels, {wb['policy_step_nodes_mean']:.1f} "
          f"nodes each); ppo_update {wb['ppo_update_card_ms']:.3f} ms "
          f"(card vs CPU max {wb['ppo_card_vs_cpu_max_abs_err']:.3g}); env "
          f"eval_cuts {wb_eval['ms']:.6f} ms against a "
          f"{wb_eval['bound_ms']:.6f} ms bound; best scanned on the sample "
          f"{wb['best_scanned_sample']:.6f} against greedy's "
          f"{wb['greedy_scanned_sample']:.6f}")
    sv = service
    print(f"service: observed ingest {sv['observe']['wall_ms']['observed']}"
          f" ms against unobserved {sv['observe']['wall_ms']['unobserved']} "
          f"ms; rebuild {sv['drift']['rebuild_s']:.3f} s; swap "
          f"{sv['lifecycle']['swap_ms']:.3f} ms; rollback "
          f"{sv['lifecycle']['rollback_ms']:.3f} ms; recovered "
          f"{sv['drift']['recovered_scanned']:.6f} against the oracle's "
          f"{sv['drift']['oracle_scanned']:.6f}; scanned at 1x and 2x "
          f"{sv['replicas']['scanned']}")
    sr, cl = serve, serve["closed_loop"]
    print(f"serve: {sr['queries_served']} queries in {SERVE_ROUNDS} sync "
          f"rounds, hit rate {sr['hit_rate']:.6f}, "
          f"{sr['engine_dispatches']} engine dispatches, "
          f"{sr['stale_responses']} stale, plan builds outside the swap "
          f"{sr['builds_outside_swap'] or 0}; hit path "
          f"{sr['hit_path_ms']['median']:.6f} ms against an engine dispatch "
          f"{sr['engine_dispatch_ms']['median']:.6f} ms "
          f"({sr['hit_speedup']:.3f}x); closed loop {cl['qps']:.1f} qps, "
          f"p50 {cl['p50_ms']:.6f} ms, p99 {cl['p99_ms']:.6f} ms, "
          f"{cl['stale_responses']} stale, plan builds {cl['builds'] or 0}")
    print("pipeline: " + "; ".join(
        f"{q['rows']} rows in {q['batches']} batches from "
        f"{q['blocks_read']} blocks, {q['records_per_s']:.1f} records/s"
        for q in pipeline["queries"]))
    print(f"coordinator: folds {fleet['fold_ms']} ms; {fleet['stats']}")
    print(f"cli: serve {cli['serve']['served']} served, "
          f"{cli['serve']['stale_responses']} stale, builds while serving "
          f"{cli['serve']['serve_builds'] or 0}, swap {cli['serve']['swap']};"
          f" ingest {cli['ingest']['n_records']} records, "
          f"{cli['ingest']['coordinator']['folds']} folds; walls "
          f"{cli['wall_s']}")
    for arch, r in lm["full"].items():
        print(f"lm_serve {arch} (full width, params {r['param_dtype']}, "
              f"compute {r['compute_dtype']}): {r['params']} params, "
              f"{r['model_flops_per_token']:.6g} model flops/token; prefill "
              f"{LM_BATCH}x{LM_PROMPT} {r['prefill_ms']:.3f} ms; decode "
              f"{r['decode_ms_per_step']:.3f} ms/step (median of "
              f"{LM_GEN - 1}), {r['tokens_per_s']:.1f} tok/s; peak "
              f"{r['peak_device_gb']:.3f} GB; decode bound "
              f"{r['decode_bound_ms']:.4f} ms; traced busy share prefill "
              f"{r['trace']['prefill']['device_busy_share']:.4f}, decode "
              f"{r['trace']['decode']['device_busy_share']:.4f}, device "
              f"ops a step {r['trace']['decode']['device_ops_per_call']}; "
              f"float32 decode vs "
              f"teacher-forced max abs err "
              f"{r['f32_decode_vs_forced_max_abs_err']:.6g}")
    print("lm_serve reduced archs, card vs CPU max abs err: " + ", ".join(
        f"{a} {r['max_abs_err']:.3g} ({r['tokens_differ']} tokens differ, "
        f"{r['near_ties']} near ties)" for a, r in lm["reduced"].items()))
    print(f"lm_serve cli: {lm['cli']['summary']}")
    for arch, r in lm_train["full"].items():
        b = r["bound"]
        print(f"lm_train {arch} (full width, {r['params']} params, "
              f"{r['microbatches']} microbatches, remat {r['remat']}): step "
              f"{r['step_ms_median']:.3f} ms (median of steps 2-"
              f"{LM_TRAIN_STEPS}; spread {r['step_ms_spread']}), "
              f"{r['tokens_per_s']:.1f} tok/s, MFU {r['mfu']:.6f}, peak "
              f"{r['peak_gb']:.3f} GB; bound {b['bound_ms']:.4f} ms by "
              f"{b['bound_by']} (bytes {b['bytes_ms']:.4f} ms, flops "
              f"{b['flops_ms']:.4f} ms); losses {r['losses']}; data tier "
              f"{r['blocks']} blocks, {r['blocks_skipped']} skipped, "
              f"launches {r['launches']}")
    tr = lm_train["trace"]
    print(f"lm_train {LM_FULL[0]} traced step: busy share "
          f"{tr['step']['device_busy_share']:.4f}, device ops "
          f"{tr['step']['device_ops_per_call']}, wall "
          f"{tr['step']['wall_ms']:.3f} ms; parts " + ", ".join(
              f"{k} {v['device_ops_per_call']} ops, {v['wall_ms']:.3f} ms, "
              f"busy {v['device_busy_share']:.4f}"
              for k, v in tr["parts"].items()))
    f32 = lm_train["f32"]
    print(f"lm_train float32: m after step 1, 2 microbatches vs 1, max rel "
          f"err {f32['microbatch_m_max_rel_err']}; remat on vs off "
          f"{f32['remat_grads_max_rel_err']:.3g} (bitwise "
          f"{f32['remat_bitwise']})")
    print("lm_train reduced archs, card vs CPU after "
          f"{LM_TRAIN_CARD_STEPS} steps, max rel err: " + ", ".join(
              f"{a} {r['state_max_rel_err']:.3g} ({r['int8_codes_differ']} "
              f"int8 codes differ)" for a, r in lm_train["reduced"].items()))
    print(f"lm_train resume: {lm_train['resume']}")
    dt = lm_shard["dtensor"]
    print(f"lm_shard {LM_FULL[0]} with DTensor leaves on the one-rank mesh, "
          f"in process: step {dt['dtensor']['step_ms_median']:.3f} ms "
          f"against {dt['plain']['step_ms_median']:.3f} ms with plain "
          f"tensors, peak {dt['dtensor']['peak_gb']:.3f} against "
          f"{dt['plain']['peak_gb']:.3f} GB; losses "
          f"{dt['losses_max_rel_err']:.3g} apart (bitwise "
          f"{dt['losses_bitwise']})")
    for key in ("ep", "ff"):
        r = lm_shard[key]
        print(f"lm_shard {key} ({r['params']} params, {r['param_gb']:.3f} "
              f"GB, {r['tokens']} tokens): forward + backward "
              f"{r['ms']['sharded']:.3f} ms through the one-rank NCCL body "
              f"against {r['ms']['local']:.3f} ms for _moe_local; bitwise "
              f"equal {all(r['equal'].values())}; each repeats bitwise "
              f"{r['repeats_bitwise']}; NCCL kernels {r['nccl_kernels']}")
    d = dryrun
    print(f"dryrun {DRYRUN_CELLS['check'][0]} x {DRYRUN_CELLS['check'][1]} "
          f"on a (1, 1) mesh: peak on the card {d['check']['peak_bytes']} B "
          f"against the dry-run's {d['predicted_peak_bytes']} B "
          f"({d['measured_over_predicted']:.4f}x); per-device peaks "
          f"{d['peaks']}; the EP all-to-all (1 group) {d['ep_all_to_all_1g']}"
          f"; records made in {d['walls_s']} s, waited {d['wait_s']:.1f} s")
    c = lm_shard["compress"]
    print(f"lm_shard compressed {LM_SHARD_COMPRESS} step "
          f"{c['compressed']['step_ms_median']:.3f} ms against plain "
          f"{c['plain']['step_ms_median']:.3f} ms (median of steps 2-"
          f"{LM_SHARD_STEPS}); last losses {c['last_loss_gap']:.6f} apart "
          f"(plain {c['plain']['losses']}, compressed "
          f"{c['compressed']['losses']}); wire {c['wire_bytes']} B against "
          f"{c['f32_bytes']} B in float32")
    print(f"fused_ingest on the finer layout ({fine.n_leaves} leaves, plan "
          f"{fine_turns['leafwise']._launch}; cluster forced "
          f"{acc_c._launch}), in turns: {fine_times}; cluster "
          f"{times['fused_ingest_cluster'][0]:.6f} "
          f"ms, the old global kernel {times['fused_ingest_global'][0]:.6f} "
          f"ms; on the main layout: shared "
          f"{times['fused_ingest_shared'][0]:.6f} ms, global "
          f"{global_on_main_ms:.6f} ms")
    for n_leaves, r in big.items():
        cp = r["forced_plans"]["cluster"]
        print(f"fused_ingest on {n_leaves} grown leaves (the plan's kernels "
              f"{r['kernels']}): " + "; ".join(
                  f"{v} ms {t['ms']} stream {t['stream_ms']}"
                  for v, t in r["times"].items())
              + f" (cluster blocks {cp['cluster']}, ranges {cp['ranges']}); "
              f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} ms")
    print(f"phase seconds: {phase_s}")
    print(json.dumps({"metrics": metrics}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
