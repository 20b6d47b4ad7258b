#!/usr/bin/env python3
"""Drive the port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py [--rows N]

At the slice's full size (a 40M-row TPC-H-like table, 150-query workload,
greedy layout of 724 blocks learned from a 1% sample), through the entry
points a user calls — ``LayoutEngine(tree)`` on the GPU: ``warm_ingest``
+ ``ingest`` (one ``fused_ingest`` launch a batch into a running
accumulator on the device), ``route`` (one ``route_descend`` launch),
``route_queries``, ``route_query`` and ``skip_stats``
(``query_intersect``).  The main path also ingests the table into a finer
layout (1,250 blocks learned from an 8,000-row sample, built in a second
process while the rest runs), whose aggregates do not fit a block's
shared memory, so ``fused_ingest`` takes its global-atomic kernel there.
It builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` first,
and checks:

* each kernel (both ``fused_ingest`` and both ``route_descend`` kernels)
  equals its plain PyTorch version on the card, exactly: on small random
  trees with every cut kind, on the finer layout, and at the main path's
  shapes; ``eval_cuts`` → ``locate_leaf``, off the main path since
  ``route`` descends directly, are still built, launched and checked;
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
  before it, launched its kernels; ``route`` launched ``route_descend``
  once a call and nothing else, by the counters and in a trace; a warm
  engine builds no plan;
* a traced ingest runs exactly one ``fused_ingest`` kernel a batch and
  copies aggregates to the host once, not once a batch.

Then this slice's paths, each counted from 0 just before it, over the same
table and layout:

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
  ``build_layout(strategy="woodblock")`` within a 60 s budget (block ids
  and Eq. 1 hits equal numpy's); one ``ppo_update`` on the card against
  the CPU's at a stated tolerance; episodes, policy steps (one a tree
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

Then it times: route and query latencies (median and spread of warm
calls, host clock; route split into its kernel, from a trace, and the
ids' copy back), whole-table ingests on fresh trees, one ingest under
``torch.profiler`` (the device's busy share), the fold of the running
accumulator into the tightener (once an ingest), and each kernel against
its plain version.  It exits non-zero on the first failure, without a
CUDA device, and when the package is not beside it.  Output, before the
last line: the card's name and power limit, build seconds, one
``{"metrics": ...}`` JSON line and one ``{"kernels": [...]}`` JSON line
(launches, median CUDA-event time, bound, plain-version time, max
difference per kernel).  The last line is ``{"ok": true, "device":
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
ORACLE_ROWS = 1 << 18
ORACLE_CHUNK = 1 << 18  # rows a host thread routes at a time
ROUTE_QUERY_N = 10  # queries routed one at a time on the main path
LAT_REPS = 10  # warm calls per latency
INGEST_REPS = 5  # untraced whole-table ingests on fresh trees
FOLD_REPS = 5  # timed folds of one stream's accumulator
FOLD_HOST_REPS = 200  # well inside the card's queue of launches
FINE_TIMEOUT_S = 900  # the finer layout's build, at most
SEED = 0
SHARD_THREADS = (1, 2, 4, 8)  # thread-shard counts over the whole table
SHARD_PROCS = (4, 2)  # process-shard counts (4 first: the pool then serves 2)
SHARD_REPS = 5  # timed sharded ingests a configuration, after the checked one
TWO_PASS_ROWS = 1 << 22  # the fused=False shard path's prefix
STORE_ROWS = 1 << 22  # the spill ingest's and the block store's prefix
SPILL_REPS = 3  # untraced whole-table spill ingests
SPILL_CHECK_BLOCKS = 5  # blocks held row for row to the oracle's ids
STORE_QUERIES = 10  # workload queries scanned from the block store
TUNED_REPS = 3  # whole-table ingests with each geometry, alternated
RANGE_COLUMN = 0  # l_shipdate: the range baseline's partitioning column
BASELINE_ROUTE_ROWS = 1 << 16  # sample rows routed through each baseline
BASELINE_TIMEOUT_S = 600  # the baselines' build, at most
WOODBLOCK_BUDGET_S = 60  # build_layout(strategy="woodblock", time_budget_s)
COPY_REPS = 3  # copies back of the env's matrix in each form, alternated
# one PPO update on the card against the CPU: float32 sums in another
# order, then one Adam step of at most lr = 3e-4 a parameter
PPO_RTOL, PPO_ATOL = 1e-4, 1e-6
SHIPDATE, EXTENDEDPRICE = 0, 5  # the drift scenario's two query columns
DRIFT_QUERIES, DRIFT_FRAC = 20, 0.04  # benchmarks/drift_rebuild.py's
RESERVOIR = 400_000  # rows a drift rebuild trains on: the 1% sample's size
ORACLE_RATIO = 1.2  # recovered scanned fraction against a greedy rebuild
OBSERVE_REPS = 3  # observed and unobserved whole-table ingests, alternated
CHECK_ROWS = 1 << 16  # rows routed against numpy around each swap
REPLICA_ROUNDS = 4  # serving rounds of each workload the tracker records

# H100 SXM (NVIDIA data sheet): HBM rate, and the float32 rate outside the
# tensor cores, taken as the rate of the kernels' int32 compares/atomics
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

FUSED = "src/repro_torch/kernels/csrc/fused_ingest.cu"
FUSED_REF = "src/repro/kernels/fused_ingest.py:213"
KERNEL_SOURCES = {
    "eval_cuts": ("src/repro_torch/kernels/csrc/eval_cuts.cu",
                  "src/repro/kernels/route_records.py:114"),
    "locate_leaf": ("src/repro_torch/kernels/csrc/locate_leaf.cu",
                    "src/repro/kernels/route_records.py:198"),
    # computes what the two Pallas kernels compose: records → block ids
    "route_descend": ("src/repro_torch/kernels/csrc/route_descend.cu",
                      "src/repro/kernels/route_records.py:114; "
                      "src/repro/kernels/route_records.py:198"),
    "fused_ingest_shared": (FUSED, FUSED_REF),
    "fused_ingest_global": (FUSED, FUSED_REF),
    "query_intersect": ("src/repro_torch/kernels/csrc/query_intersect.cu",
                        "src/repro/kernels/query_intersect.py:94"),
}
VARIANTS = ("shared", "global")
# kernels off the main path: ``route`` no longer goes through them
OFF_PATH = ("eval_cuts", "locate_leaf")


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
    copies, fills) in ms, the ``fused_ingest`` kernels' ms and count, and
    the device-to-host copies."""
    import torch

    spans, kernel_ms, kernels, d2h = [], 0.0, 0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        if "fused_ingest" in ev.name:
            kernel_ms += (ev.time_range.end - ev.time_range.start) / 1e3
            kernels += 1
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


def traced_kernel_ms(fn, name: str, reps: int) -> float:
    """Median device time of the kernel ``name`` over ``reps`` calls of
    ``fn`` under ``torch.profiler``; ``fn`` launches ``name`` once a call
    and no other kernel of the repo."""
    spans = traced_kernels(fn, reps)
    counts = {k: len(v) for k, v in spans.items()}
    require(counts == {name: reps},
            f"the trace shows {counts} kernels for {reps} calls; expected "
            f"{reps} {name}")
    return float(np.median(spans[name]))


def traced_kernel_sample(fn, name: str, reps: int) -> dict:
    """Device times of the kernel ``name`` over ``reps`` calls of ``fn``
    under ``torch.profiler``, where the trace may drop some of its
    events (it dropped seven of ten 0.1 ms ``eval_cuts`` kernels at the
    env's shape on the H100): the median of those it kept and their
    count.  The launches themselves are counted by the wrappers.  Fails
    if it kept none, or shows another kernel of the repo."""
    spans = traced_kernels(fn, reps)
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


def route_forced(rec, ops, variant):
    """Block ids by one ``route_descend`` kernel, ``variant`` forced."""
    from repro_torch.kernels import route_records as rk

    with rk._forced(variant):
        plan = rk.route_plan(ops)
    require(plan[0] == 1 + VARIANTS.index(variant),
            f"route_descend planned kernel {plan[0]} for {variant}")
    return rk.route(rec, {**ops, "route_plan": plan})


def compare_kernels(tree, rec, wt, dev, ctx: str,
                    variants=VARIANTS) -> dict[str, float]:
    """Each kernel against its plain version on the same inputs (exact):
    both kernels of ``eval_cuts``, ``locate_leaf`` and ``route_descend``,
    the last also against the two-kernel form."""
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
    errs["route_descend"] = 0.0
    for v in VARIANTS:
        got = route_forced(rec, ops, v)
        require(max_abs_err([got], [two_kernel]) == 0.0,
                f"{ctx}: route_descend ({v}) differs from eval_cuts → "
                f"locate_leaf")
        errs["route_descend"] = max(errs["route_descend"],
                                    max_abs_err([got], [want]))
    for v in variants:
        errs[f"fused_ingest_{v}"] = fused_err(ops, [rec], v)
    qargs = query_args(tree, wt, dev)
    errs["query_intersect"] = max_abs_err(qk.query_intersect(*qargs),
                                          qk.query_intersect_plain(*qargs))
    for name, e in errs.items():
        require(e == 0.0, f"{ctx}: {name} kernel differs from its plain "
                          f"version by {e}")
    return errs


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
        fused = launched["fused_ingest_shared"] + launched[
            "fused_ingest_global"]
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
                fused = (worker["fused_ingest_shared"]
                         + worker["fused_ingest_global"])
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
    require(launched["fused_ingest_shared"] + launched["fused_ingest_global"]
            == n, f"spill ingest: {launched} for {n} batches")
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


def store_phase(ctx, counted, buf, tree) -> dict:
    """``write_store`` into a temporary directory, then ``scan_query`` of
    STORE_QUERIES workload queries: each scan's rows equal a brute-force
    ``Query.evaluate`` over the table, in block order, and no matching
    row lies in a block the query skipped."""
    import shutil
    import tempfile

    from repro_torch.data.blocks import BlockStore

    records, schema = ctx["records"], tree.schema
    oracle_bids = ctx["oracle_bids"]
    root = Path(tempfile.mkdtemp(prefix="qd-store-"))
    try:
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
    finally:
        shutil.rmtree(root, ignore_errors=True)
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
    ``ppo_update`` on the card against the same update on the CPU."""
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

    # one PPO update on the card against the CPU, from the last update's
    # inputs
    card_net, cpu_net = last["net"], copy.deepcopy(last["net"]).cpu()
    cpu_opt = {"m": {k: v.cpu() for k, v in last["opt"]["m"].items()},
               "v": {k: v.cpu() for k, v in last["opt"]["v"].items()},
               "t": last["opt"]["t"]}
    cpu_batch = {k: v.cpu() for k, v in last["batch"].items()}
    cfg = last["cfg"]
    timing_net, timing_opt = (copy.deepcopy(card_net),
                              copy.deepcopy(last["opt"]))
    card_net, card_opt, _ = ppo.ppo_update(card_net, last["opt"],
                                           last["batch"], cfg)
    cpu_net, cpu_opt, _ = ppo.ppo_update(cpu_net, cpu_opt, cpu_batch, cfg)
    ppo_err, ppo_ok = 0.0, True
    pairs = [(a.detach().cpu(), b.detach()) for (_, a), (_, b) in zip(
        card_net.named_parameters(), cpu_net.named_parameters())]
    pairs += [(card_opt[s][k].cpu(), cpu_opt[s][k])
              for s in ("m", "v") for k in cpu_opt[s]]
    for a, b in pairs:
        diff = (a - b).abs()
        ppo_err = max(ppo_err, float(diff.max()))
        ppo_ok &= bool((diff <= PPO_ATOL + PPO_RTOL * b.abs()).all())
    require(ppo_ok, f"ppo_update on the card differs from the CPU's beyond "
                    f"rtol {PPO_RTOL}, atol {PPO_ATOL} (max {ppo_err})")
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
        "ppo_tolerance": {"rtol": PPO_RTOL, "atol": PPO_ATOL},
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
        f"vs CPU max {ppo_err:.3g}")
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
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        fine_job = pool.apply_async(fine_layout, (SEED,))
        return run(args, dev, torch, pool, fine_job)


def run(args, dev, torch, pool, fine_job) -> int:
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

    # -- small random trees: every kernel (both fused kernels) vs plain, and
    # the running fold over uneven batches --------------------------------
    for seed in (1, 2):
        tree, recs, work = random_case(seed)
        rec = torch.from_numpy(recs).to(dev)
        tree.tighten(recs, tree.route(recs))
        ctx = f"random tree {seed}"
        compare_kernels(tree, rec, work.tensorize(tree.cuts), dev, ctx)
        running_fold(tree, rec, recs, [0, 1, 777, 20_000, 20_001, 50_000],
                     dev, ctx, VARIANTS, workers)
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
    t0 = time.perf_counter()
    fine_arrays = fine_job.get(timeout=FINE_TIMEOUT_S)
    fine_wait_s = time.perf_counter() - t0
    fine = FrozenQdTree.from_arrays(fine_arrays)
    log(f"finer layout: {fine.n_leaves} leaves, depth {fine.depth} (waited "
        f"{fine_wait_s:.1f}s for it)")
    untightened = tree.to_arrays()
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
    require(path_launches["route"] == {
        k: 2 if k == "route_descend" else 0 for k in _build.LAUNCH_NAMES
    }, f"two route calls launched {path_launches['route']}; expected one "
       f"route_descend each and nothing else")

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
    oracle_tree = FrozenQdTree.from_arrays(untightened)
    oracle_bids, part = oracle_partial(oracle_tree, records, workers)
    tightener = IncrementalTightener(oracle_tree)
    tightener.merge(part)
    tightener.apply()
    oracle_s = time.perf_counter() - t0
    for f in ("leaf_lo", "leaf_hi", "leaf_cat", "leaf_adv", "block_sizes"):
        require(np.array_equal(getattr(oracle_tree, f), getattr(tree, f)),
                f"whole-stream {f} differs from the numpy oracle")
    log(f"whole stream: tightened descriptions equal the numpy oracle's "
        f"({oracle_s:.1f}s on {workers} host threads)")
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
    route_kernel_ms = traced_kernel_ms(lambda: engine.route(slices[0]),
                                       "route_descend", LAT_REPS)
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
                                variants=("global",))
    fops = route_ops(fine, dev)
    before = _build.launch_counts()
    fk.IngestAccumulator(fops).fold(slices[0])
    after = _build.launch_counts()
    require(after["fused_ingest_global"] == before["fused_ingest_global"] + 1
            and after["fused_ingest_shared"] == before["fused_ingest_shared"],
            "the finer layout's aggregates should take the global kernel")
    try:
        with fk._forced("shared"):
            fk.IngestAccumulator(fops).fold(slices[0])
        refused = False
    except RuntimeError:
        refused = True
    require(refused, "a shared-memory request past the card's limit must "
                     "raise")
    errs["fused_ingest_global"] = max(errs["fused_ingest_global"],
                                      fine_errs["fused_ingest_global"])
    n_run = min(n_rows, 3 * BATCH // 2)
    bounds = sorted({0, 1, 1000, min(BATCH - 3, n_run), n_run})
    running_fold(tree, rec_dev, records, bounds, dev, "main path shapes",
                 VARIANTS, workers)
    log("main path shapes: every kernel equals its plain version; running "
        "fold equal to the plain version and the numpy oracle")

    # -- timing ---------------------------------------------------------------
    x = slices[0]
    ops = route_ops(tree, dev)
    leaf, conj, layout = query_args(tree, wt, dev)
    m_mat = rk.eval_cuts(x, ops)
    acc_s, acc_g = fk.IngestAccumulator(ops), fk.IngestAccumulator(fops)
    acc_p, acc_gp = fk.IngestAccumulator(ops), fk.IngestAccumulator(fops)
    with fk._forced("global"):
        acc_gm = fk.IngestAccumulator(ops)
    runs = {
        "eval_cuts": (lambda: rk.eval_cuts(x, ops),
                      lambda: rk.eval_cuts_plain(x, ops)),
        "locate_leaf": (lambda: rk.locate_leaf(m_mat, ops),
                        lambda: rk.locate_leaf_plain(m_mat, ops)),
        "route_descend": (lambda: rk.route(x, ops),
                          lambda: rk.route_plain(x, ops)),
        # as the ingest folds a batch: no block ids
        "fused_ingest_shared": (
            lambda: acc_s.fold(x),
            lambda: fk.fused_ingest_plain(x, acc_p, bids=False)),
        "fused_ingest_global": (
            lambda: acc_g.fold(x),
            lambda: fk.fused_ingest_plain(x, acc_gp, bids=False)),
        "query_intersect": (lambda: qk.query_intersect(leaf, conj, layout),
                            lambda: qk.query_intersect_plain(leaf, conj,
                                                             layout)),
    }
    times = {n: (time_ms(k, 20), time_ms(p, 3)) for n, (k, p) in runs.items()}
    # the global kernel on the main layout (the same work as the shared
    # one); the host side of one fold (wrapper and launch, no sync) and
    # the shared kernel's plan
    global_on_main_ms = time_ms(lambda: acc_gm.fold(x), 20)
    # route_descend's global kernel on the main layout, and its planned
    # kernel on the finer layout
    route_global_on_main_ms = time_ms(lambda: route_forced(x, ops, "global"),
                                      20)
    route_fine_ms = time_ms(lambda: rk.route(x, fops), 20)
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
    q_kernel_ms = traced_kernel_ms(
        lambda: qk.query_intersect(leaf, conj, layout), "query_intersect",
        LAT_REPS)

    # -- this slice's paths, each counted from 0: sharded ingest, spill,
    # block store, autotune, baselines -------------------------------------
    ctx = {
        "dev": dev, "records": records, "rec_dev": rec_dev, "slices": slices,
        "sizes": sizes, "n_rows": n_rows, "untightened": untightened,
        "oracle_tree": oracle_tree, "oracle_bids": oracle_bids,
        "oracle_partial": part, "single_partial": single_partial,
        "workers": workers, "path_launches": path_launches,
        "worker_launches": [], "work": work, "wt": wt, "sample": sample,
    }
    phase_s = {}
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
    store = store_phase(pctx, counted, spill_buf, spill_tree)
    del spill_buf
    phase_s["store"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tuned = autotune_phase(ctx, counted)
    phase_s["autotune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    layouts = base_job.get(timeout=BASELINE_TIMEOUT_S)
    phase_s["baseline_wait"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    baselines = baseline_phase(ctx, counted, layouts)
    phase_s["baseline"] = time.perf_counter() - t0
    # -- the layout lifecycle: WOODBLOCK and the service layers, each path
    # counted from 0 ---------------------------------------------------------
    ctx["cuts"] = cuts
    ctx["greedy_scanned_sample"] = baselines["qdtree"]["scanned_fraction"]
    t0 = time.perf_counter()
    woodblock = woodblock_phase(ctx, counted)
    phase_s["woodblock"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    service = service_phase(ctx, counted)
    phase_s["service"] = time.perf_counter() - t0
    # every path's launches, the process shards' (made in their workers)
    # included
    launches = {k: sum(c[k] for c in path_launches.values())
                + sum(w.get(k, 0) for w in ctx["worker_launches"])
                for k in _build.LAUNCH_NAMES}
    log(f"launches by path: {path_launches}; in process-shard workers: "
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
        "route_descend": bound(
            m * d * 4 + nodes + int(ops["in_mask"].numel()) + m * 4, path),
        "fused_ingest_shared": fused_bound(tree, ops, route_bids, m, d),
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
    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        ms, plain_ms = times[name]
        bound_ms, bound_by = bounds_ms[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
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
        "route_descend_fine_ms": route_fine_ms,
        "eval_cuts_batch": eval_cuts_batch,
        "locate_leaf_trace": locate_trace,
        "locate_leaf_path_sectors": sectors,
        "eval_cuts_plan": dict(zip(plan_keys, rk.eval_cuts_plan(ops))),
        "locate_leaf_plan": dict(zip(plan_keys, rk.locate_leaf_plan(ops))),
        "fused_fold_host_ms": fold_host_ms,
        "fused_shared_plan": shared_plan,
        "query_intersect_kernel_ms": q_kernel_ms,
        "route_ms_per_batch": route_ms,
        # its kernel alone (trace of engine.route calls) and the ids' copy
        # back (host clock around .cpu() of a batch's ids)
        "route_kernel_ms": route_kernel_ms,
        "route_copy_ms": route_copy_ms,
        "route_plan": dict(zip(plan_keys, rk.route_plan(ops))),
        "route_plan_fine": dict(zip(plan_keys, rk.route_plan(fops))),
        "route_queries_ms": queries_ms,
        "route_query_ms": query_ms,
        "scanned_fraction": stats.scanned_fraction,
        "selectivity_lower_bound_sample": lower,
        "build_s": build_s, "build_s_per_kernel": per_kernel,
        "datagen_s": datagen_s, "greedy_s": greedy_s,
        "fine_wait_s": fine_wait_s, "oracle_s": oracle_s,
        "host_threads": workers,
        "sharded_ingest": shards, "spill_ingest": spill,
        "block_store": store, "autotune": tuned, "baselines": baselines,
        "woodblock": woodblock, "service": service,
        "phase_s": phase_s,
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
    print(json.dumps({"metrics": metrics}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
