"""The serving tier as a long-lived front end over a LayoutService.

Drives a paced (open-loop) query stream — a Zipf-repeated mix, the shape
real dashboards produce — through :class:`repro_torch.serve.QueryServer`:
admission, micro-batch coalescing, and the semantic result cache, with
every served query recorded into a WorkloadTracker.  Each cache miss batch
is one engine dispatch: on the card one ``query_intersect`` launch.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --rows 30000 --qps 500 --duration 10 --cache-size 4096

    # tracker-inferred mid-run rebuild: at half time the layout is rebuilt
    # from the workload the tracker inferred off the serving path alone,
    # hot-swapped live, and the cache invalidates by generation epoch
    PYTHONPATH=src python -m repro_torch.launch.serve --workload auto

    # the kernels' plain versions on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

``--device`` defaults to the GPU and raises without one; ``--backend
numpy`` is the host oracle.  Prints per-phase progress plus a final JSON
summary (achieved qps, cache hit rate, p50/p99 latency, admission and
staleness counters, plan builds while serving) like
``repro_torch.launch.ingest``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core import query as qry
from repro_torch.engine.plan import build_counts, build_delta
from repro_torch.launch.ingest import make_workload
from repro_torch.serve import AdmissionError, QueryServer, ServeConfig
from repro_torch.service import LayoutService


def zipf_mix(work: qry.Workload, n: int, s: float, seed: int) -> list[qry.Query]:
    """``n`` queries drawn Zipf(s)-by-rank from the workload's templates —
    a few hot predicates dominate, a long tail repeats rarely (the mix a
    semantic cache exists for)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, len(work) + 1, dtype=np.float64)
    p = ranks**-s
    p /= p.sum()
    order = rng.permutation(len(work))  # hot set is seed-dependent
    idx = order[rng.choice(len(work), size=n, p=p)]
    return [work.queries[int(i)] for i in idx]


def serve_builds(warm: dict, end: dict, swap: dict) -> dict:
    """Plan builds between ``warm`` and ``end`` outside the swap's window
    (``swap``: the builds from the rebuild's start to the end of the new
    generation's warm), by name."""
    total = build_delta(warm, end)
    return {k: n - swap.get(k, 0) for k, n in total.items()
            if n != swap.get(k, 0)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--rows", type=int, default=30_000)
    ap.add_argument("--qps", type=float, default=500.0,
                    help="open-loop submit rate target")
    ap.add_argument("--duration", type=float, default=10.0,
                    help="serving run length, seconds")
    ap.add_argument("--cache-size", type=int, default=4096,
                    help="semantic result cache capacity (LRU entries)")
    ap.add_argument("--workload", default="tpch",
                    choices=("tpch", "errorlog_int", "auto"),
                    help="query mix; 'auto' additionally rebuilds the "
                         "layout MID-RUN from the tracker-inferred mix "
                         "and hot-swaps it (the cache invalidates by "
                         "generation epoch)")
    ap.add_argument("--zipf", type=float, default=1.1,
                    help="Zipf skew of the repeated query mix")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="coalesced dispatch size trigger")
    ap.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="coalescing deadline per request")
    ap.add_argument("--backend", default="torch",
                    choices=("torch", "numpy"),
                    help="'torch' runs the CUDA kernels on the GPU (their "
                         "plain versions with --device cpu); 'numpy' is "
                         "the host oracle")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without "
                         "one); 'cpu' runs the kernels' plain versions")
    ap.add_argument("--strategy", default="greedy")
    ap.add_argument("--min-block", type=int, default=600)
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica count for the mid-run rebuild: k>1 "
                         "clusters the inferred mix into k workload "
                         "clusters and deploys one qd-tree per cluster "
                         "with cheapest-replica routing (k x storage)")
    ap.add_argument("--lam", type=float, default=0.25,
                    help="uniform-prior blend weight for per-replica "
                         "workload clusters")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    schema, records, work, cuts = make_workload(
        args.workload, args.rows, args.seed
    )
    service = LayoutService.build(
        records, work, strategy=args.strategy, backend=args.backend,
        device=args.device, cuts=cuts, min_block=args.min_block,
        seed=args.seed,
    )
    print(
        f"[serve] built {args.strategy} layout: {service.tree.n_leaves} "
        f"blocks over {records.shape[0]} rows, backend={args.backend} on "
        f"{service.device}"
    )
    tracker = service.workload_tracker()
    config = ServeConfig(
        max_batch=args.max_batch,
        max_delay_s=args.max_delay_ms / 1e3,
        cache_capacity=args.cache_size,
    )
    server = QueryServer(service, config, tracker=tracker).start()
    server.warm(work)
    t_warm = build_counts()
    swap_builds: dict = {}
    print(
        f"[serve] serving at {args.qps:,.0f} qps target for "
        f"{args.duration:.0f}s (zipf s={args.zipf}, max_batch="
        f"{args.max_batch}, deadline {args.max_delay_ms}ms, cache "
        f"{args.cache_size})"
    )

    n_target = max(int(args.qps * args.duration), 1)
    mix = zipf_mix(work, n_target, args.zipf, args.seed + 1)
    tickets = []
    rejected = 0
    swap_note = None
    burst = max(int(args.qps * 0.005), 1)  # pace in ~5ms bursts
    t0 = time.perf_counter()
    swap_at = t0 + args.duration / 2
    i = 0
    while i < len(mix):
        if args.workload == "auto" and swap_note is None and (
            time.perf_counter() >= swap_at
        ):
            # rebuild from what the serving path inferred — no declared
            # workload in the loop — and hot-swap under live traffic
            b_swap = build_counts()
            inferred = tracker.infer_workload()
            target = inferred if len(inferred) else work
            if args.replicas > 1:
                rep = service.rebuild_replicas(
                    records, workload=target, k=args.replicas,
                    lam=args.lam, min_block=args.min_block,
                    seed=args.seed,
                )
                server.warm(work)  # every replica's plans: swap cost
                swap_builds = build_delta(b_swap, build_counts())
                swap_note = {
                    "swapped": rep.swapped,
                    "replicas": rep.k,
                    "generation": service.generation,
                    "replica_generations": list(
                        service.replica_generations()
                    ),
                    "inferred_queries": len(inferred),
                }
                print(
                    f"[serve] mid-run replica rebuild from inferred mix "
                    f"({len(inferred)} weighted queries, k={rep.k}): "
                    f"{'deployed gens ' + str(rep.new_generations) if rep.swapped else 'kept gens ' + str(rep.old_generations)}"
                )
            else:
                rep = service.rebuild(
                    records, target, min_block=args.min_block,
                    seed=args.seed,
                )
                server.warm(work)  # new generation's plans: swap cost
                swap_builds = build_delta(b_swap, build_counts())
                swap_note = {
                    "swapped": rep.swapped,
                    "generation": service.generation,
                    "inferred_queries": len(inferred),
                }
                print(
                    f"[serve] mid-run rebuild from inferred mix "
                    f"({len(inferred)} weighted queries): "
                    f"{'swapped to gen ' + str(rep.new_generation) if rep.swapped else 'kept gen ' + str(rep.old_generation)}"
                )
        t_due = t0 + i / args.qps
        now = time.perf_counter()
        if now < t_due:
            time.sleep(t_due - now)
        for q in mix[i : i + burst]:
            try:
                tickets.append(server.submit(q))
            except AdmissionError:
                rejected += 1
        i += burst
    results = [t.result(timeout=30.0) for t in tickets]
    wall = time.perf_counter() - t0
    server.stop()

    stats = server.stats()
    serving = serve_builds(t_warm, build_counts(), swap_builds)
    state = tracker.snapshot()
    print(
        f"[serve] {len(results)} served / {rejected} shed in {wall:.2f}s "
        f"-> {len(results) / wall:,.0f} qps achieved"
    )
    print(
        f"[serve] cache: hit rate {stats['cache']['hit_rate']:.3f} "
        f"({stats['cache']['hits']} hits / {stats['cache']['lookups']} "
        f"lookups), {stats['counters']['engine_dispatches']} engine "
        f"dispatches for {stats['counters']['dispatches']} batches"
    )
    print(
        f"[serve] latency: p50 {stats['latency']['p50_ms']:.2f}ms "
        f"p99 {stats['latency']['p99_ms']:.2f}ms"
    )
    print(
        f"[serve] staleness audit: {stats['counters']['stale_responses']} "
        f"stale responses, {stats['cache']['stale_puts']} stale puts, "
        f"plan builds during serving (the swap's excluded): "
        f"{serving or 0}, during the swap: {swap_builds or 0}"
    )
    for line in tracker.describe(3):
        print(f"[serve] inferred: {line}")

    summary = {
        "qps_target": args.qps,
        "qps_achieved": len(results) / wall if wall else 0.0,
        "duration_s": wall,
        "served": len(results),
        "rejected": rejected,
        "hit_rate": stats["cache"]["hit_rate"],
        "p50_ms": stats["latency"]["p50_ms"],
        "p99_ms": stats["latency"]["p99_ms"],
        "stale_responses": stats["counters"]["stale_responses"],
        "serve_builds": serving,
        "swap_builds": swap_builds,
        # kernel launches in this process (on the CPU the plain
        # versions run and count nothing)
        "launches": service.engine.stats()["launches"],
        "device": str(service.device),
        "n_blocks": service.tree.n_leaves,
        "counters": stats["counters"],
        "admission": stats["admission"],
        "cache": stats["cache"],
        "generation": service.generation,
        "workload": args.workload,
        "swap": swap_note,
        "tracker": {
            "queries_seen": state.queries_seen,
            "n_keys": state.n_keys,
            "inferred_queries": len(tracker.infer_workload()),
        },
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
