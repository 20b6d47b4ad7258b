#!/usr/bin/env python3
"""Drive the port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py [--rows N]

At the slice's full size (a 40M-row TPC-H-like table, 150-query workload,
greedy layout of ~728 blocks learned from a 1% sample), through the
entry points a user calls — ``LayoutEngine(tree)`` on the GPU:
``warm_ingest`` + ``ingest`` (the ``fused_ingest`` kernel), ``route``
(``eval_cuts`` + ``locate_leaf``), ``route_queries``, ``route_query`` and
``skip_stats`` (``query_intersect``).  It builds the four CUDA kernels
from ``src/repro_torch/kernels/csrc`` first, and checks:

* each kernel equals its plain PyTorch version on the card, exactly, on a
  small random tree with every cut kind and at the main path's shapes;
* the whole stream's tightened descriptions equal the plain path's;
* the first 2**18 rows equal the numpy oracle (``fused_ingest_ref``);
* route's block ids equal ``fused_step``'s, ``route_query`` equals
  ``route_queries``, and the query hits and per-conjunct scan counts
  equal the numpy backend's;
* every kernel launched during the main path, and a warm engine builds no
  plan.

Then it times: route and query latencies (median and spread of warm
calls, host clock), whole-table ingests on fresh trees, one ingest under
``torch.profiler`` (the device's busy share), and the per-batch host fold
alone.  It exits non-zero on the first failure, without a CUDA device,
and when the package is not beside it.  Output, before the last line: the
card's name and power limit, build seconds, one ``{"kernels": [...]}``
JSON line (launches, median CUDA-event time, bound, plain-version time,
max difference per kernel) and one ``{"metrics": ...}`` JSON line.  The last
line is ``{"ok": true, "device": {...}}``.  ``--rows`` cuts the row count
(the only cut allowed; it is printed).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FULL_ROWS = 40_000_000
BATCH = 1 << 20
SAMPLE_EVERY = 100  # a 1% sample for the greedy build
MIN_BLOCK = 400  # in sample records: ~40k rows a block at full size
ORACLE_ROWS = 1 << 18
ROUTE_QUERY_N = 10  # queries routed one at a time on the main path
LAT_REPS = 10  # warm calls per latency
INGEST_REPS = 5  # untraced whole-table ingests on fresh trees
SEED = 0

# H100 SXM (NVIDIA data sheet): HBM rate, and the float32 rate outside the
# tensor cores, taken as the rate of the kernels' int32 compares/atomics
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

KERNEL_SOURCES = {
    "eval_cuts": ("src/repro_torch/kernels/csrc/eval_cuts.cu",
                  "src/repro/kernels/route_records.py:114"),
    "locate_leaf": ("src/repro_torch/kernels/csrc/locate_leaf.cu",
                    "src/repro/kernels/route_records.py:198"),
    "fused_ingest": ("src/repro_torch/kernels/csrc/fused_ingest.cu",
                     "src/repro/kernels/fused_ingest.py:213"),
    "query_intersect": ("src/repro_torch/kernels/csrc/query_intersect.cu",
                        "src/repro/kernels/query_intersect.py:94"),
}


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


def host_ms(fn, reps: int) -> dict:
    """Host-clock ms of ``fn`` (calls that end on the host): median and
    spread over ``reps`` warm calls, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"median": float(np.median(times)), "min": min(times),
            "max": max(times), "n": reps}


def device_busy_ms(prof) -> tuple[float, float, int]:
    """From a profiler trace: the union of all device activity (kernels,
    copies, fills) in ms, and the ``fused_ingest`` kernels' ms and count."""
    import torch

    spans, kernel_ms, kernels = [], 0.0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((ev.time_range.start, ev.time_range.end))
        if "fused_ingest" in ev.name:
            kernel_ms += (ev.time_range.end - ev.time_range.start) / 1e3
            kernels += 1
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3, kernel_ms, kernels


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


def compare_kernels(tree, rec, wt, dev, ctx: str) -> dict[str, float]:
    """Each kernel against its plain version on the same inputs (exact)."""
    from repro_torch.engine import plan as tplan
    from repro_torch.kernels import fused_ingest as fk
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import query_intersect as qk
    from repro_torch.kernels import route_records as rk

    ops = tplan.to_device(tplan.pack_route_constants(tree), dev)
    errs = {}
    m_k = rk.eval_cuts(rec, ops)
    errs["eval_cuts"] = max_abs_err([m_k], [rk.eval_cuts_plain(rec, ops)])
    errs["locate_leaf"] = max_abs_err([rk.locate_leaf(m_k, ops)],
                                      [rk.locate_leaf_plain(m_k, ops)])
    errs["fused_ingest"] = max_abs_err(fk.fused_ingest(rec, ops),
                                       fk.fused_ingest_plain(rec, ops))
    n_adv = tree.cuts.n_adv
    qargs = (
        tplan.to_device(tplan.pack_leaf_descs(tree), dev),
        tplan.to_device(kops.pack_workload(wt, n_adv), dev),
        tplan.to_device(kops.query_layout(tree.schema, n_adv), dev),
    )
    errs["query_intersect"] = max_abs_err(qk.query_intersect(*qargs),
                                          qk.query_intersect_plain(*qargs))
    for name, e in errs.items():
        require(e == 0.0, f"{ctx}: {name} kernel differs from its plain "
                          f"version by {e}")
    return errs


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=FULL_ROWS,
                    help="row count of the table (cut only if forced)")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = require_cuda()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import rewards
    from repro_torch.core.greedy import GreedyConfig, build_greedy
    from repro_torch.core.qdtree import FrozenQdTree, IncrementalTightener
    from repro_torch.data.datagen import make_tpch_like
    from repro_torch.data.workload import make_tpch_workload
    from repro_torch.engine import LayoutEngine, backends as be
    from repro_torch.engine import plan as tplan
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_ingest as fk
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import query_intersect as qk
    from repro_torch.kernels import route_records as rk
    from repro_torch.kernels.ref import fused_ingest_ref, partial_from_fused

    t_start = time.perf_counter()
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

    # -- small random trees: every cut kind, each kernel vs plain ------------
    for seed in (1, 2):
        tree, recs, work = random_case(seed)
        rec = torch.from_numpy(recs).to(dev)
        tree.tighten(recs, tree.route(recs))
        compare_kernels(tree, rec, work.tensorize(tree.cuts), dev,
                        f"random tree {seed}")
    torch.cuda.synchronize()
    log("small random trees: all four kernels equal their plain versions")

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
    untightened = tree.to_arrays()
    rec_dev = torch.from_numpy(records).to(dev)
    slices = [rec_dev[s:s + BATCH] for s in range(0, n_rows, BATCH)]
    torch.cuda.synchronize()

    # -- the main path, counted ----------------------------------------------
    engine = LayoutEngine(tree)  # backend "torch" on the GPU
    require(engine.device == dev, f"engine on {engine.device}")
    _build.reset_launch_counts()
    engine.warm_ingest({s.shape[0] for s in slices})
    report = engine.ingest(slices)
    require(report.builds == {},
            f"plans built during the warm ingest: {report.builds}")
    route_bids = engine.route(slices[0])
    fused_bids, _ = engine.fused_step(slices[0])
    lists = engine.route_queries(work)
    stats = engine.skip_stats(rec_dev, work)
    lists = engine.route_queries(work)  # against the tightened descriptions
    one = [engine.route_query(q) for q in work.queries[:ROUTE_QUERY_N]]
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    log(f"main path launches: {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} never launched on the main path")

    # -- what came out is right ----------------------------------------------
    require(np.array_equal(route_bids, fused_bids),
            "route and fused_step disagree on block ids")
    require(len(lists) == len(work) and stats.n_blocks == tree.n_leaves,
            "query routing shapes")
    for q, bids in enumerate(one):
        require(np.array_equal(bids, lists[q]),
                f"route_query differs from route_queries on query {q}")
    require(int(report.block_sizes.sum()) == n_rows
            and np.array_equal(report.block_sizes, stats.block_sizes),
            "block sizes")
    plain_tree = FrozenQdTree.from_arrays(untightened)
    ops = tplan.to_device(tplan.pack_route_constants(plain_tree), dev)
    tightener = IncrementalTightener(plain_tree)
    for s in slices:
        tightener.merge(partial_from_fused(plain_tree,
                                           fk.fused_ingest_plain(s, ops)))
    tightener.apply()
    for f in ("leaf_lo", "leaf_hi", "leaf_cat", "leaf_adv", "block_sizes"):
        require(np.array_equal(getattr(plain_tree, f), getattr(tree, f)),
                f"whole-stream {f} differs from the plain torch path")
    log("whole stream: tightened descriptions equal the plain torch path")
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
    queries_ms = host_ms(lambda: engine.route_queries(work), LAT_REPS)
    query_ms = host_ms(lambda: engine.route_query(work.queries[0]), LAT_REPS)
    engine.fused_step(slices[-1], return_bids=False)
    require(tplan.build_counts() == warm, "a warm engine built a plan")

    # -- ingest: its spread over fresh trees, the device's busy share from a
    # profiler trace, and the per-batch host fold timed alone -------------
    sizes = {s.shape[0] for s in slices}

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
    busy_ms, fused_kernel_ms, n_fused = device_busy_ms(prof)
    require(n_fused == len(slices),
            f"the trace shows {n_fused} fused_ingest kernels for "
            f"{len(slices)} batches")
    fold_tree = FrozenQdTree.from_arrays(untightened)
    fold = IncrementalTightener(fold_tree)
    fold_ms = []
    for s in slices:
        out = fk.fused_ingest(s, ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fold.merge(partial_from_fused(fold_tree, out))
        fold_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"ingest walls {walls}; traced {traced.wall_s:.6f}s, device busy "
        f"{busy_ms:.3f} ms, fused kernels {fused_kernel_ms:.3f} ms")

    # -- kernels vs plain at the main path's shapes, then timing -------------
    errs = compare_kernels(tree, slices[0], wt, dev, "main path shapes")
    leaf = tplan.to_device(tplan.pack_leaf_descs(tree), dev)
    conj = tplan.to_device(kops.pack_workload(wt, cuts.n_adv), dev)
    layout = tplan.to_device(kops.query_layout(schema, cuts.n_adv), dev)
    ops = tplan.to_device(tplan.pack_route_constants(tree), dev)
    x = slices[0]
    m_mat = rk.eval_cuts(x, ops)
    runs = {
        "eval_cuts": (lambda: rk.eval_cuts(x, ops),
                      lambda: rk.eval_cuts_plain(x, ops)),
        "locate_leaf": (lambda: rk.locate_leaf(m_mat, ops),
                        lambda: rk.locate_leaf_plain(m_mat, ops)),
        "fused_ingest": (lambda: fk.fused_ingest(x, ops),
                         lambda: fk.fused_ingest_plain(x, ops)),
        "query_intersect": (lambda: qk.query_intersect(leaf, conj, layout),
                            lambda: qk.query_intersect_plain(leaf, conj,
                                                             layout)),
    }
    times = {n: (time_ms(k, 20), time_ms(p, 3)) for n, (k, p) in runs.items()}

    # -- bounds from this run's inputs ---------------------------------------
    m, d = x.shape
    C, L, bits = cuts.n_cuts, tree.n_leaves, int(ops["bits"])
    a3, n_adv = int(ops["adv"].shape[0]), cuts.n_adv
    n_cat = int(ops["cat_dims"].shape[0])
    table = sum(int(v.numel() * v.element_size()) for k, v in ops.items()
                if k in ("kind", "dim", "cutpoint", "in_mask", "cat_off",
                         "adv", "adv_id"))
    nodes = 4 * 4 * tree.n_nodes
    path = int(leaf_depths(tree)[route_bids].sum())  # cuts read on descent
    nq = wt.n_conjuncts
    n_num = int(layout["num_dims"].shape[0])
    bounds = {
        "eval_cuts": bound(m * d * 4 + table + m * C, m * C),
        "locate_leaf": bound(path + nodes + m * 4, path),
        "fused_ingest": bound(
            m * d * 4 + table + nodes + m * 4
            + L * (4 + 8 * d + bits + 2 * a3),
            path + m * (2 * d + n_cat + n_adv + 1),
        ),
        "query_intersect": bound(
            L * (8 * d + bits + 2 * a3 + 8) + nq * (8 * d + bits + 2 * a3)
            + L * nq + 8 * nq,
            L * nq * (2 * n_num + bits + 2 * n_adv) + L * nq,
        ),
    }
    kernels = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        ms, plain_ms = times[name]
        bound_ms, bound_by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    metrics = {
        "rows": n_rows, "batch": BATCH, "queries": len(work),
        "conjuncts": nq, "cuts": C, "adv_cuts": n_adv, "cat_bits": bits,
        "leaves": L, "nodes": tree.n_nodes, "depth": tree.depth,
        "ingest_records_per_s": n_rows / float(np.median(walls)),
        "ingest_s": {"median": float(np.median(walls)), "min": min(walls),
                     "max": max(walls), "n": INGEST_REPS},
        "ingest_first_s": report.wall_s,
        # one ingest under torch.profiler: the union of device activity
        # over that ingest's wall
        "ingest_traced_s": traced.wall_s,
        "ingest_device_busy_ms": busy_ms,
        "ingest_fused_kernel_ms": fused_kernel_ms,
        "ingest_device_busy_share": busy_ms / (traced.wall_s * 1e3),
        "fold_ms_per_batch": {
            "median": float(np.median(fold_ms)), "min": min(fold_ms),
            "max": max(fold_ms), "n": len(fold_ms),
        },
        "route_ms_per_batch": route_ms,
        "route_queries_ms": queries_ms,
        "route_query_ms": query_ms,
        "scanned_fraction": stats.scanned_fraction,
        "selectivity_lower_bound_sample": lower,
        "build_s": build_s, "build_s_per_kernel": per_kernel,
        "datagen_s": datagen_s, "greedy_s": greedy_s,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "total_s": time.perf_counter() - t_start,
    }
    print(smi)
    print(f"build seconds: {build_s:.3f}")
    print(json.dumps({"metrics": metrics}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
