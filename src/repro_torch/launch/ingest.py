"""Sustained online ingestion through the LayoutEngine.

Demonstrates the layout engine as a long-lived service (cf. the
dynamic-layout follow-up work): records arrive as micro-batches of
*varying* sizes, each batch is routed and folded on the backend (on the
card one ``fused_ingest`` launch a batch), appended to per-block buffers,
and leaf descriptions are tightened incrementally — all without building a
plan, because a plan serves every batch size.

    PYTHONPATH=src python -m repro_torch.launch.ingest \
        --rows 60000 --batch 2048 --backend torch --workload tpch \
        --store /tmp/qd_store                      # on the GPU

    PYTHONPATH=src python -m repro_torch.launch.ingest \
        --rows 20000 --device cpu                  # plain versions, CPU

``--device`` defaults to the GPU and raises without one; ``--device cpu``
runs the kernels' plain PyTorch versions.  ``--backend numpy`` is the host
oracle.  Prints per-phase throughput plus the engine's plan-cache and
plan-build counters and (optionally) persists the ingested blocks as a
BlockStore; the last line is a JSON summary.

Workload auto-detection (``repro_torch.service.tracker``): ``--track-workload``
simulates live traffic — between ingest rounds, query batches sampled from
the workload are *served* through ``LayoutService.serve`` and recorded into
a WorkloadTracker; the inferred top-of-mix is printed at the end.
``--workload auto`` goes further: the drift monitor is given NO declared
workload at all — per-batch Eq. 1 accounting and any auto-rebuild score
against the tracker-inferred live mix (re-inferred at trigger time).

    # observe the serving path, print the inferred mix
    PYTHONPATH=src python -m repro_torch.launch.ingest --rows 30000 \
        --track-workload

    # fully self-optimizing: drift + rebuilds driven by the inferred mix
    PYTHONPATH=src python -m repro_torch.launch.ingest --rows 30000 \
        --workload auto --drift --drift-abs 0.5
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.core import query as qry
from repro_torch.data import datagen, workload as wl
from repro_torch.data.blocks import BlockBuffers
from repro_torch.engine import build_counts
from repro_torch.service import (
    DriftConfig,
    IngestOptions,
    LayoutService,
    RebuildPolicy,
)


def make_workload(name: str, rows: int, seed: int):
    if name in ("tpch", "auto"):  # auto: tpch data, tracker-inferred mix
        schema, records = datagen.make_tpch_like(rows, seed=seed)
        work, _ = wl.make_tpch_workload(schema, n_per_template=5, seed=seed)
        cuts = work.candidate_cuts(max_adv=4)
    elif name == "errorlog_int":
        schema, records = datagen.make_errorlog_int(rows, seed=seed)
        work, _ = wl.make_errorlog_int_workload(
            schema, n_queries=100, seed=seed
        )
        cuts = work.candidate_cuts()
    else:
        raise SystemExit(f"unknown workload {name!r}")
    return schema, records, work, cuts


def batch_sizes(n_rows: int, mean_batch: int, seed: int) -> list[int]:
    """Arrival-like batch sizes with ±50% jitter (plus the tail remainder)."""
    rng = np.random.default_rng(seed)
    sizes: list[int] = []
    left = n_rows
    lo = max(mean_batch // 2, 1)
    hi = max(mean_batch * 3 // 2, lo + 1)  # keep lo < hi for mean_batch=1
    while left > 0:
        b = int(rng.integers(lo, hi))
        sizes.append(min(b, left))
        left -= sizes[-1]
    return sizes


def micro_batches(records: np.ndarray, sizes: list[int]):
    i = 0
    for b in sizes:
        yield records[i : i + b]
        i += b


def serve_round(rng, work, n_queries: int) -> "qry.Workload":
    """A live-traffic sample: what users are asking between ingest rounds."""
    idx = rng.integers(0, len(work), n_queries)
    return qry.Workload(
        work.schema, tuple(work.queries[int(i)] for i in idx)
    )


def merge_round_reports(reports):
    """Fold per-round ingest reports into one stream-level summary."""
    builds: dict = {}
    obs = None
    for r in reports:
        for name, n in r.builds.items():
            builds[name] = builds.get(name, 0) + n
        if r.observation is not None:
            obs = r.observation if obs is None else obs.merge(r.observation)
    return dataclasses.replace(
        reports[-1],
        n_records=sum(r.n_records for r in reports),
        n_batches=sum(r.n_batches for r in reports),
        wall_s=sum(r.wall_s for r in reports),
        builds=builds,
        observation=obs,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--rows", type=int, default=60_000)
    ap.add_argument("--batch", type=int, default=2048,
                    help="mean micro-batch size (sizes jitter ±50%%)")
    ap.add_argument("--backend", default="torch",
                    choices=("torch", "numpy"),
                    help="'torch' runs the CUDA kernels on the GPU (their "
                         "plain versions with --device cpu); 'numpy' is "
                         "the host oracle")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; raises without "
                         "one); 'cpu' runs the kernels' plain versions")
    ap.add_argument("--workload", default="tpch",
                    choices=("tpch", "errorlog_int", "auto"),
                    help="query workload; 'auto' serves tpch data but "
                         "gives the drift loop NO declared workload — "
                         "drift accounting and rebuilds score against the "
                         "mix a WorkloadTracker infers from the serving "
                         "path (implies --track-workload)")
    ap.add_argument("--track-workload", action="store_true",
                    help="serve sampled query batches through "
                         "LayoutService.serve between ingest rounds, "
                         "recording each query's predicate signature into "
                         "a WorkloadTracker; prints the inferred mix")
    ap.add_argument("--serve-queries", type=int, default=8,
                    help="queries served (and tracked) per ingest round")
    ap.add_argument("--strategy", default="greedy",
                    help="layout construction strategy "
                         "(repro_torch.service builder registry)")
    ap.add_argument("--min-block", type=int, default=600)
    ap.add_argument("--shards", type=int, default=1,
                    help="ingest with N parallel shard ingestors "
                         "(associative merge; bit-identical to --shards 1)")
    ap.add_argument("--executor", default="auto",
                    choices=("auto", "thread", "process"),
                    help="shard executor (--shards > 1): 'thread' runs "
                         "the shards on CUDA streams of the live engine's "
                         "context (the 'auto' default on the GPU); "
                         "'process' routes shards in resident spawn "
                         "workers against a shipped tree replica on the "
                         "same device (the 'auto' default on the CPU, "
                         "where threads share one GIL); the other choice "
                         "warns")
    ap.add_argument("--coordinator", action="store_true",
                    help="route sharded rounds through a FleetCoordinator: "
                         "rounds submit ShardState/TrackerState partials "
                         "instead of publishing locally; the coordinator "
                         "folds them on --cadence and owns every publish")
    ap.add_argument("--cadence", type=int, default=4,
                    help="coordinator fold cadence, in submitted partials")
    ap.add_argument("--no-fused", action="store_true",
                    help="use the two-pass route+tighten path instead of "
                         "the fused single-pass kernel")
    ap.add_argument("--rebuild", action="store_true",
                    help="after ingest, rebuild on the full corpus and "
                         "hot-swap if the Eq.1 skip rate improves")
    ap.add_argument("--drift", action="store_true",
                    help="monitor the stream's Eq.1 skip rate against the "
                         "workload and auto-rebuild (hot-swap via CAS) "
                         "when it degrades past the --drift-* policy")
    ap.add_argument("--drift-window", type=int, default=16,
                    help="sliding window length, in observations")
    ap.add_argument("--drift-abs", type=float, default=None,
                    help="absolute scanned-fraction trigger threshold "
                         "(unset: relative rule only)")
    ap.add_argument("--drift-rel", type=float, default=0.5,
                    help="trigger when the window rate degrades past "
                         "best_seen*(1+REL); <=0 disables the rule")
    ap.add_argument("--drift-hysteresis", type=int, default=2,
                    help="consecutive breaching observations required")
    ap.add_argument("--drift-cooldown", type=int, default=16,
                    help="observations blocked after a trigger")
    ap.add_argument("--drift-reservoir", type=int, default=65536,
                    help="recent-record reservoir capacity rebuilds "
                         "train on")
    ap.add_argument("--replicas", type=int, default=1,
                    help="replica count for drift-triggered rebuilds: "
                         "k>1 deploys a k-replica set with cheapest-"
                         "replica routing (k x storage)")
    ap.add_argument("--lam", type=float, default=0.25,
                    help="uniform-prior blend weight for per-replica "
                         "workload clusters (0=pure inferred mix, "
                         "1=pure uniform)")
    ap.add_argument("--store", default=None,
                    help="optional path to persist the ingested BlockStore")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    schema, records, work, cuts = make_workload(
        args.workload, args.rows, args.seed
    )
    # build the layout on a bootstrap sample, then stream the full corpus in
    sample = records[: max(args.rows // 10, 1000)]
    sample_min_block = max(
        args.min_block * sample.shape[0] // max(args.rows, 1), 50
    )
    service = LayoutService.build(
        sample, work, strategy=args.strategy, backend=args.backend,
        device=args.device, cuts=cuts, min_block=sample_min_block,
        seed=args.seed,
    )
    frozen = service.tree
    print(
        f"[ingest] built {args.strategy} layout on {sample.shape[0]} "
        f"bootstrap rows in {service.version(1).build.build_s:.2f}s "
        f"({frozen.n_leaves} blocks, depth {frozen.depth}) on "
        f"{service.device}"
    )

    tracker = None
    if args.track_workload or args.workload == "auto":
        tracker = service.workload_tracker()
        print(
            "[ingest] workload tracking on: serving "
            f"{args.serve_queries} sampled queries per round through "
            "LayoutService.serve"
        )

    monitor = None
    if args.drift:
        rel = args.drift_rel if args.drift_rel > 0 else None
        monitor = service.auto_rebuilder(RebuildPolicy(
            workload="auto" if args.workload == "auto" else work,
            tracker=tracker,
            drift=DriftConfig(
                window=args.drift_window,
                min_fill=max(args.drift_window // 4, 1),
                abs_threshold=args.drift_abs,
                rel_degradation=rel,
                hysteresis=args.drift_hysteresis,
                cooldown=args.drift_cooldown,
            ),
            replicas=args.replicas,
            lam=args.lam,
            reservoir_capacity=args.drift_reservoir,
            # auto mode derives candidate cuts from the *inferred*
            # workload at trigger time — pinning the declared cut table
            # would defeat the point of inferring the mix
            rebuild_kw=(
                dict(min_block=args.min_block, seed=args.seed)
                if args.workload == "auto"
                else dict(
                    cuts=cuts, min_block=args.min_block, seed=args.seed
                )
            ),
        ))
        print(
            f"[ingest] drift monitor on: window={args.drift_window} "
            f"abs={args.drift_abs} rel={rel} "
            f"hysteresis={args.drift_hysteresis} "
            f"cooldown={args.drift_cooldown} "
            f"reservoir={args.drift_reservoir} "
            f"workload={'auto (tracker-inferred)' if args.workload == 'auto' else 'declared'}"
        )

    engine = service.engine
    buffers = BlockBuffers.for_tree(frozen)
    fused = not args.no_fused
    # warmup: build the ingest plan (and load the kernels) before the
    # stream; one plan serves every batch size, so one warm batch covers
    # the jittered stream and its tail — the ingest loop builds no plan
    if args.shards > 1:
        from repro_torch.engine.sharded import warm_sizes

        sizes = sorted(warm_sizes(records.shape[0], args.shards, args.batch))
    else:
        sizes = batch_sizes(records.shape[0], args.batch, args.seed)
    if fused:
        engine.warm_ingest(sizes[:1])
    else:
        engine.route(records[: sizes[0]])
    qrng = np.random.default_rng(args.seed + 7)
    if tracker is not None:
        # round 0 of live traffic: the tracker must know something before
        # an auto-mode monitor can score batches against an inferred mix
        # (also builds the live tree's query plan)
        service.serve(
            serve_round(qrng, work, args.serve_queries), tracker=tracker
        )
    if monitor is not None:
        # drift accounting probes the scored workload's query plan once
        # per ingest run — build the plan of the workload it will probe
        # (auto mode: the fixed-budget inferred mix, not the declared
        # workload) so the stream itself builds no plan
        observed = monitor.current_workload()
        engine.query_hits(
            observed if observed is not None and len(observed) else work
        )
    executor = None if args.executor == "auto" else args.executor
    coordinator = None
    if args.coordinator:
        if args.shards <= 1:
            raise SystemExit("--coordinator needs --shards > 1")
        from repro_torch.coordinator import FleetCoordinator

        coordinator = FleetCoordinator(
            service, cadence=args.cadence, tracker=tracker
        )
        print(
            f"[ingest] fleet coordinator on: folds every "
            f"{args.cadence} submitted partial(s); rounds submit "
            "aggregates instead of publishing locally"
        )
    if args.shards > 1:
        if monitor is None and tracker is None and coordinator is None:
            shard_rounds = [service.ingest(
                records, buffers=buffers,
                options=IngestOptions(
                    shards=args.shards, batch=args.batch,
                    executor=executor, fused=fused,
                ),
            )]
            report = shard_rounds[0]
        else:
            # one sharded run yields ONE drift observation — stream in
            # rounds so the monitor sees a sequence it can trigger on
            # (min_fill/hysteresis need consecutive observations), the
            # tracker's decay generations advance with the stream, and a
            # coordinator gets a cadence of partials to fold
            n_rounds = max(args.drift_window, 4)
            chunk = max(-(-records.shape[0] // n_rounds), args.shards)
            shard_rounds = []
            for s in range(0, records.shape[0], chunk):
                if service.tree is not frozen:
                    # a rebuild or coordinator fold deployed: later rounds
                    # route on the new live tree — restart buffers for it
                    frozen = service.tree
                    buffers = BlockBuffers.for_tree(frozen)
                    print(
                        "[ingest] new generation live; block buffers "
                        "restarted for its geometry"
                    )
                if tracker is not None:
                    service.serve(
                        serve_round(qrng, work, args.serve_queries),
                        tracker=tracker,
                    )
                shard_rounds.append(service.ingest(
                    records[s : s + chunk], buffers=buffers,
                    options=IngestOptions(
                        shards=args.shards, batch=args.batch,
                        monitor=monitor, executor=executor, fused=fused,
                        coordinator=coordinator,
                    ),
                ))
            report = merge_round_reports(shard_rounds)
        last = shard_rounds[-1]
        print(
            f"[ingest] {args.shards} shards routed in "
            f"{max(last.shard_wall_s):.2f}s (slowest shard, last round) "
            f"-> {last.shard_records_per_s:,.0f} rec/s pooled; "
            f"merge+publish {last.merge_s*1e3:.1f}ms"
        )
        if any(r.stale_generation for r in shard_rounds):
            print(
                "[ingest] publish skipped for a round: the tree was "
                "hot-swapped out mid-run (stale generation)"
            )
        if coordinator is not None:
            if coordinator.stats()["pending"]:
                coordinator.fold()  # flush partials below the cadence
            cstats = coordinator.stats()
            print(
                f"[ingest] coordinator: {cstats['folds']} fold(s), "
                f"{cstats['stale_dropped']} stale partial(s) dropped, "
                f"live generation {service.generation} "
                f"(desc v{service.live_epoch().desc_version})"
            )
            service.close_ingest_sessions()
    elif tracker is not None:
        # live traffic interleaves with ingestion: serve a sampled query
        # round, then ingest a chunk of the stream — every round closes
        # one tracker decay generation, and an auto-mode monitor
        # re-infers the mix it scores against at each round
        n_rounds = max(args.drift_window, 8)
        per_round = max(-(-len(sizes) // n_rounds), 1)
        round_reports = []
        off = 0
        for r in range(0, len(sizes), per_round):
            if service.tree is not frozen:
                frozen = service.tree
                buffers = BlockBuffers.for_tree(frozen)
                print(
                    "[ingest] drift rebuild deployed; block buffers "
                    "restarted for the new generation"
                )
            round_sizes = sizes[r : r + per_round]
            n_round = sum(round_sizes)
            service.serve(
                serve_round(qrng, work, args.serve_queries),
                tracker=tracker,
            )
            round_reports.append(service.ingest(
                micro_batches(records[off : off + n_round], round_sizes),
                buffers=buffers,
                options=IngestOptions(monitor=monitor, fused=fused),
            ))
            off += n_round
        report = merge_round_reports(round_reports)
    else:
        report = service.ingest(
            micro_batches(records, sizes), buffers=buffers,
            options=IngestOptions(monitor=monitor, fused=fused),
        )
    print(
        f"[ingest] {report.n_records} records / {report.n_batches} "
        f"micro-batches in {report.wall_s:.2f}s -> "
        f"{report.records_per_s:,.0f} rec/s on backend={report.backend}"
    )
    print(f"[ingest] plan cache: {report.plan_cache}")
    print(f"[ingest] plan builds during ingest (empty ⇒ fully warm): "
          f"{report.builds}")
    print(f"[ingest] all plan builds: {build_counts()}")

    drift_summary = None
    if monitor is not None:
        monitor.drain()
        monitor.close()
        if report.observation is not None:
            print(
                f"[ingest] drift: stream scanned fraction "
                f"{report.observation.scanned_fraction:.4f} over "
                f"{report.observation.n_records} observed records"
            )
        for ev in monitor.events:
            if ev.deployed:
                # single-tree rebuilds carry new_generation; replica
                # rebuilds carry the whole set's new_generations
                gens = getattr(
                    ev.report, "new_generation", None
                ) or tuple(getattr(ev.report, "new_generations", ()))
                deployed_what = f"deployed gen {gens}"
            what = (
                f"skipped ({ev.skipped})" if ev.skipped
                else f"error ({ev.error})" if ev.error
                else deployed_what if ev.deployed
                else "kept live tree (candidate not better)"
            )
            print(
                f"[ingest] drift trigger at obs {ev.observation} "
                f"({ev.decision.reason}, window "
                f"{ev.decision.window_rate:.4f}): {what}"
            )
        drift_summary = {
            "observed_scanned_fraction": (
                report.observation.scanned_fraction
                if report.observation is not None else None
            ),
            "triggers": len(monitor.events),
            "rebuilds_deployed": monitor.rebuilds_deployed,
            "generation": service.generation,
            "workload": (
                "auto" if args.workload == "auto" else "declared"
            ),
        }

    tracker_summary = None
    if tracker is not None:
        state = tracker.snapshot()
        inferred = tracker.infer_workload()
        print(
            f"[ingest] tracker: {state.n_keys} signatures over "
            f"{state.queries_seen} served queries "
            f"({state.generation} decay generations); inferred mix = "
            f"{len(inferred)} weighted queries"
        )
        for line in tracker.describe(5):
            print(f"[ingest] inferred: {line}")
        tracker_summary = {
            "queries_seen": state.queries_seen,
            "n_keys": state.n_keys,
            "generation": state.generation,
            "inferred_queries": len(inferred),
        }

    # score the CURRENT live tree — a drift rebuild may have swapped it
    stats = service.engine.skip_stats(records, work, tighten=False)
    print(
        f"[ingest] layout quality: scanned fraction "
        f"{stats.scanned_fraction:.4f} over {stats.n_queries} queries"
    )

    rebuild_summary = None
    if args.rebuild:
        # the bootstrap tree was built on 10% of the corpus — rebuild on
        # everything and hot-swap behind the serving facade if it wins
        rep = service.rebuild(
            records, work, cuts=cuts, min_block=args.min_block,
            seed=args.seed,
        )
        print(
            f"[ingest] rebuild: live {rep.live_scanned:.4f} vs candidate "
            f"{rep.candidate_scanned:.4f} -> "
            f"{'swapped to gen ' + str(rep.new_generation) if rep.swapped else 'kept gen ' + str(rep.old_generation)}"
        )
        rebuild_summary = {
            "swapped": rep.swapped,
            "live_scanned": rep.live_scanned,
            "candidate_scanned": rep.candidate_scanned,
            "generation": service.generation,
        }

    if args.store:
        store = buffers.write_store(args.store, frozen)
        print(
            f"[ingest] persisted {int(store.sizes.sum())} rows in "
            f"{store.sizes.shape[0]} blocks at {store.root}"
        )
    summary = {
        "records_per_s": report.records_per_s,
        "n_records": report.n_records,
        "n_batches": report.n_batches,
        "backend": report.backend,
        "strategy": args.strategy,
        "n_shards": args.shards,
        "fused": fused,
        "executor": args.executor if args.shards > 1 else None,
        "device": str(service.device),
        "n_blocks": service.tree.n_leaves,
        "plan_cache": report.plan_cache,
        "ingest_builds": report.builds,
        # kernel launches in this process (on the CPU the plain
        # versions run and count nothing)
        "launches": service.engine.stats()["launches"],
        "scanned_fraction": stats.scanned_fraction,
        "rebuild": rebuild_summary,
        "coordinator": (
            coordinator.stats() if coordinator is not None else None
        ),
        "drift": drift_summary,
        "workload": args.workload,
        "workload_tracking": tracker_summary,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
