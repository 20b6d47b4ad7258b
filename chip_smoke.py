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
    """Each kernel against its plain version on the same inputs (exact);
    ``route_descend`` (both kernels) also against the two-kernel form."""
    from repro_torch.kernels import query_intersect as qk
    from repro_torch.kernels import route_records as rk

    ops = route_ops(tree, dev)
    errs = {}
    m_k = rk.eval_cuts(rec, ops)
    errs["eval_cuts"] = max_abs_err([m_k], [rk.eval_cuts_plain(rec, ops)])
    two_kernel = rk.locate_leaf(m_k, ops)
    errs["locate_leaf"] = max_abs_err([two_kernel],
                                      [rk.locate_leaf_plain(m_k, ops)])
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=FULL_ROWS,
                    help="row count of the table (cut only if forced)")
    args = ap.parse_args(argv)

    import torch

    dev = require_cuda()
    sys.path.insert(0, str(ROOT / "src"))
    # the finer layout is learned in a second process while the rest runs
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        fine_job = pool.apply_async(fine_layout, (SEED,))
        return run(args, dev, torch, fine_job)


def run(args, dev, torch, fine_job) -> int:
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
    _, part = oracle_partial(oracle_tree, records, workers)
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
    # the query kernel's own device time, without the wrapper's host side
    q_kernel_ms = traced_kernel_ms(
        lambda: qk.query_intersect(leaf, conj, layout), "query_intersect",
        LAT_REPS)

    # -- bounds from this run's inputs ---------------------------------------
    m, d = x.shape
    C, L, bits = cuts.n_cuts, tree.n_leaves, int(ops["bits"])
    table = sum(int(v.numel() * v.element_size()) for k, v in ops.items()
                if k in ("kind", "dim", "cutpoint", "in_mask", "cat_off",
                         "adv", "adv_id"))
    nodes = 4 * 4 * tree.n_nodes
    path = int(leaf_depths(tree)[route_bids].sum())  # cuts read on descent
    nq = wt.n_conjuncts
    n_num = int(layout["num_dims"].shape[0])
    n_ent, aw = int(layout["seg_word"].shape[0]), int(layout["aw"])
    kl, kc = int(leaf["desc"].shape[1]), int(conj["desc"].shape[1])
    bounds_ms = {
        "eval_cuts": bound(m * d * 4 + table + m * C, m * C),
        "locate_leaf": bound(path + nodes + m * 4, path),
        "route_descend": bound(
            m * d * 4 + nodes + int(ops["in_mask"].numel()) + m * 4, path),
        "fused_ingest_shared": fused_bound(tree, ops, route_bids, m, d),
        "fused_ingest_global": fused_bound(fine, fops, fine_route_bids, m, d),
        "query_intersect": bound(
            4 * (L * kl + nq * kc) + 8 * L + L * nq + 8 * nq,
            L * nq * (2 * n_num + n_ent + 4 * aw) + L * nq,
        ),
    }
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
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "total_s": time.perf_counter() - t_start,
    }
    print(smi)
    print(f"build seconds: {build_s:.3f}")
    print(f"fold once an ingest: {fold_med:.6f} ms "
          f"({fold_med / n_batches:.6f} ms over each of {n_batches} batches)")
    print(json.dumps({"metrics": metrics}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
