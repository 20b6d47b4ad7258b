"""The benchmark of the qd-tree layout path on PyTorch and CUDA.

    python3 qdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of ``BENCHMARK.json``: make the cell's rows on the
card from ``--seed``, load its layout file, warm the entry, drive passes
of the traffic mix through it for ``--seconds`` (a closed loop; a pass
sends the deployment's whole table), then hold what the window produced
to the plain reference, and print one JSON line.
With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a ``torch.profiler`` trace
of the window, the program's counters and the harness's spans.

Everything that belongs to one configuration, mix, entry or per-layer
metric is a file found by name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``entries/<entry>.py``, ``metrics/<metric>.py``.
``--fault`` plants a fault under the timed path (``faults.py``); the
benchmark's own runs never pass it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names
TRACE_SECONDS = 10.0  # the traced part of a traced run's window


def _paths() -> None:
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # every cache of the run inside the checkout, at fixed paths
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))


_paths()

import torch  # noqa: E402

from qdbench import bound, check, faults, layout, reference, stream  # noqa: E402
from qdbench import trace as tracing  # noqa: E402
from qdbench.spans import Recorder  # noqa: E402


def log(msg: str) -> None:
    print(f"[qdbench] {msg}", file=sys.stderr, flush=True)


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "qdbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> list:
    """The top-level names of ``names`` (the loaded modules by default)
    that are one of FORBIDDEN, each compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def process_age() -> float:
    """Seconds since this process started (the kernel's record of its
    start, to a clock tick), else since this module was first run."""
    try:
        stat = pathlib.Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launch_delta(before: dict, after: dict) -> dict:
    from repro_torch.kernels import _build

    return {k: after[k] - before[k] for k in _build.LAUNCH_NAMES
            if after[k] != before[k]}


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, device: str = "cuda", sizes: dict | None = None,
             fault: str | None = None) -> dict:
    """One run of a cell; the result line as a dict.  ``sizes`` overrides
    the configuration's ``resident_rows``, ``batch_rows`` and
    ``pass_rows`` (CPU tests)."""
    from repro_torch.core.qdtree import FrozenQdTree
    from repro_torch.engine import LayoutEngine, build_counts
    from repro_torch.kernels import _build

    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    config = layout.load_config(cell["config"])
    config.update(sizes or {})
    mix = stream.load_mix(cell["traffic"])
    entry = importlib.import_module(f"qdbench.entries.{mix['entry']}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    steps = {"imports_and_context": process_age()}
    arrays = layout.load(config)
    rows, batches = stream.make(mix, config, seed, dev)
    sync(dev)
    steps["rows"] = process_age()
    sent = int(config["pass_rows"])
    with faults.planted(fault, arrays, dev):
        tree = FrozenQdTree.from_arrays(arrays)
        engine = LayoutEngine(tree, device=dev)
        engine.warm_ingest({int(b.shape[0]) for b in batches})
        steps["warm"] = process_age()
        entry.run_pass(engine, batches, Recorder())  # the warm pass
        sync(dev)
        setup_s = steps["warm_pass"] = process_age()
        log("set-up, s from the process's start: " + ", ".join(
            f"{k} {v:.3f}" for k, v in steps.items()))

        # -- the window ----------------------------------------------------
        # A traced run traces its first TRACE_SECONDS (to a pass's end) and
        # reads the trace once the window has closed.
        rec = Recorder()
        passes, kept = [], []
        keep_at = seed % 3  # the pass whose outputs are held whole
        prof, traced_at = None, None
        if traced:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA
                if dev.type == "cuda" else
                torch.profiler.ProfilerActivity.CPU], acc_events=True)
            prof.start()
            rec.intervals = []
        launches0, builds0 = _build.launch_counts(), build_counts()
        sync(dev)
        t0, t0_ns = time.perf_counter(), time.time_ns()
        while True:
            out = entry.run_pass(engine, batches, rec)
            if len(passes) == keep_at:
                kept.append(check.description(tree))
            passes.append({"rows": out["rows"], "counts": out["counts"]})
            elapsed = time.perf_counter() - t0
            if prof is not None and traced_at is None and (
                    elapsed >= min(seconds, TRACE_SECONDS)):
                sync(dev)
                traced_at = (time.time_ns(), rec.batches_handed,
                             launch_delta(launches0, _build.launch_counts()),
                             rec.intervals)
                rec.intervals = None
                prof.stop()
            if elapsed >= seconds:
                break
        sync(dev)
        t1 = time.perf_counter()
        launches = launch_delta(launches0, _build.launch_counts())
        builds = {k: v - builds0.get(k, 0) for k, v in build_counts().items()
                  if v != builds0.get(k, 0)}
        kept.append(check.description(tree))
    window_s = t1 - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    trace, traced_batches, traced_launches = None, 0, {}
    if prof is not None:
        t_read = time.perf_counter()
        end_ns, traced_batches, traced_launches, spans = traced_at
        trace = tracing.reduce(prof, t0_ns, end_ns, spans)
        del prof
        log(f"trace: {len(trace.device)} device events over "
            f"{trace.window_s:.3f} s, read in "
            f"{time.perf_counter() - t_read:.1f} s")
    pass_s = sorted(rec.seconds["pass"])
    log(f"{cell_name}: {len(passes)} passes, {rec.batches_handed} batches "
        f"in {window_s:.3f} s (a pass {pass_s[0]:.6f} to {pass_s[-1]:.6f} s, "
        f"median {pass_s[len(pass_s) // 2]:.6f}); launches {launches}; "
        f"plan builds {builds}")

    # -- the reference, once the program's state is freed -----------------
    del engine, tree
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_layout = reference.Layout(arrays, dev)
    resident_rows = int(rows.shape[0])
    head, tail, touched = reference.route_and_fold(
        ref_layout, rows, sent % resident_rows, config["batch_rows"])
    ref_counts, ref_fold = check.expected(head, tail, sent, resident_rows)
    numbers = check.fold_numbers(passes, sent, kept, ref_counts, ref_fold)
    failed = check.failed_passes(passes, sent, ref_counts)
    del head, tail, ref_fold
    touched = touched.sort().values.cpu()
    log(f"reference and comparison: {time.perf_counter() - t_ref:.3f} s; "
        f"leaves a resident batch touches: {int(touched[0])} to "
        f"{int(touched[-1])}, median {int(touched[len(touched) // 2])} of "
        f"{ref_layout.n_leaves}")

    # -- metrics --------------------------------------------------------------
    obs = types.SimpleNamespace(
        trace=trace, launches=launches, builds=builds,
        batches=rec.batches_handed, spans=dict(rec.seconds),
        traced_launches=traced_launches, traced_batches=traced_batches,
        bound_s_per_batch=bound.fold_seconds(
            arrays, ref_counts, len(batches))["seconds"])
    metrics = {}
    if traced:
        for m in bench["per_layer"]:
            if cell_name not in m.get("workloads", [cell_name]):
                continue
            value = metric_reader(m["name"])(obs)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        rows_done = sum(int(p["rows"]) for p in passes)
        values = {entry.METRIC: rows_done / window_s, "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if m["name"] in values and cell_name in m.get("workloads",
                                                          [cell_name]):
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    result = {
        "correct": all(numbers[k] <= check.LIMITS[k] for k in numbers),
        "attempted": rec.batches_handed,
        "failed": failed * len(batches),  # batches of the passes failed
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace is not None:
        result["device"]["busy_s"] = trace.busy_s
        result["device"]["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", choices=faults.FAULTS, default=None)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"no cell {args.workload!r}; cells: {sorted(cells)}")
        return 2
    need = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"needs {need} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" available; nothing was run")
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), fault=args.fault)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark may load none of "
            f"{FORBIDDEN}")
        return 3
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
