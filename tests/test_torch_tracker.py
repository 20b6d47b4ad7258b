"""The port's workload tracker against ``repro.service.tracker`` on the CPU.

Signatures (from atoms and from tensors), ``TrackerState`` merges at k
shards, ticks, inference and the npz format equal the reference's
exactly; the engine's ``track=`` hook and ``LayoutService.serve`` record
what the reference's do, and the ``workload="auto"`` drift loop takes the
reference's decisions.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import query as rqry  # noqa: E402
from repro.engine import LayoutEngine as RefEngine  # noqa: E402
from repro.service import DriftConfig as RConfig  # noqa: E402
from repro.service import IngestOptions as RIngestOptions  # noqa: E402
from repro.service import LayoutService as RefService  # noqa: E402
from repro.service import RebuildPolicy as RPolicy  # noqa: E402
from repro.service import TrackerConfig as RTrackerConfig  # noqa: E402
from repro.service import TrackerState as RState  # noqa: E402
from repro.service import WorkloadTracker as RTracker  # noqa: E402
from repro.service import build_layout as rbuild_layout  # noqa: E402
from repro.service import merge_states as rmerge  # noqa: E402
from repro.service import tracker as rtracker  # noqa: E402
from repro_torch.core import query as tqry  # noqa: E402
from repro_torch.engine import LayoutEngine  # noqa: E402
from repro_torch.service import (  # noqa: E402
    DriftConfig,
    IngestOptions,
    LayoutService,
    RebuildPolicy,
    TrackerConfig,
    TrackerState,
    WorkloadTracker,
    build_layout,
    merge_states,
)
from repro_torch.service import tracker as ttracker  # noqa: E402
from tests.test_torch_woodblock import to_port  # noqa: E402
from tests.test_tracker import (  # noqa: E402
    SCHEMA,
    _random_query,
    _random_workload,
    _setup,
)

TSCHEMA = to_port(SCHEMA)
CFG = dict(n_buckets=64, n_gens=8, decay=0.5)


def assert_states_equal(port, ref):
    for f in ("decay", "n_gens", "n_buckets", "generation", "queries_seen"):
        assert getattr(port, f) == getattr(ref, f), f
    assert sorted(port.counts) == sorted(ref.counts)
    for k, v in ref.counts.items():
        np.testing.assert_array_equal(port.counts[k], v)
        assert port.counts[k].dtype == v.dtype


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_signatures_match_repro(seed):
    work = _random_workload(seed, n=10)
    twork = to_port(work)
    cuts = work.candidate_cuts()
    tcuts = twork.candidate_cuts()
    for n_buckets in (10, 64, 1 << 62):
        assert ttracker.query_signatures(twork, n_buckets) == (
            rtracker.query_signatures(work, n_buckets))
        assert ttracker.query_signatures(
            twork, n_buckets, adv_filter=ttracker.adv_filter_for(tcuts)
        ) == rtracker.query_signatures(
            work, n_buckets, adv_filter=rtracker.adv_filter_for(cuts))
        assert ttracker.query_signatures_from_tensors(
            twork.tensorize(tcuts), TSCHEMA, adv=tcuts.adv,
            n_buckets=n_buckets,
        ) == rtracker.query_signatures_from_tensors(
            work.tensorize(cuts), SCHEMA, adv=cuts.adv, n_buckets=n_buckets)
    for sig in rtracker.query_signatures(work, 64):
        assert ttracker.query_from_signature(sig, TSCHEMA) == to_port(
            rtracker.query_from_signature(sig, SCHEMA))


def _replay(streams, k, tracker_cls, schema, cfg, workload_cls, port):
    trackers = [tracker_cls(schema, cfg) for _ in range(k)]
    for rnd in streams:
        for j, q in enumerate(rnd):
            q = to_port(q) if port else q
            trackers[j % k].record(workload_cls(schema, (q,)))
        for t in trackers:
            t.tick()
    return [t.snapshot() for t in trackers]


@pytest.mark.parametrize("seed", [0, 5, 17])
def test_kway_merges_match_repro(seed):
    rng = np.random.default_rng(seed)
    streams = [
        [_random_query(rng) for _ in range(int(rng.integers(1, 9)))]
        for _ in range(5)
    ]
    single = None
    for k in (1, 2, 4, 8):
        ref = rmerge(_replay(streams, k, RTracker, SCHEMA,
                             RTrackerConfig(**CFG), rqry.Workload, False))
        port_states = _replay(streams, k, WorkloadTracker, TSCHEMA,
                              TrackerConfig(**CFG), tqry.Workload, True)
        port = merge_states(port_states)
        assert_states_equal(port, ref)
        # pairwise merges in another association land on the same bits
        folded = port_states[-1]
        for s in reversed(port_states[:-1]):
            folded = s.merge(folded)
        assert folded.equals(port)
        single = port if single is None else single
        assert port.equals(single)
        assert port.top_signatures(8) == ref.top_signatures(8)
        assert port.weights() == ref.weights()
        assert port.infer_workload(TSCHEMA, top_k=8, budget=16).queries == (
            to_port(ref.infer_workload(SCHEMA, top_k=8, budget=16).queries))


def test_state_npz_crosses_packages(tmp_path):
    t = WorkloadTracker(TSCHEMA, TrackerConfig(**CFG))
    r = RTracker(SCHEMA, RTrackerConfig(**CFG))
    for seed in range(3):
        w = _random_workload(seed)
        t.record(to_port(w))
        r.record(w)
        t.tick()
        r.tick()
    assert_states_equal(t.snapshot(), r.snapshot())
    p = str(tmp_path / "port.npz")
    t.snapshot().save(p)
    assert_states_equal(RState.load(p), r.snapshot())
    q = str(tmp_path / "ref.npz")
    r.snapshot().save(q)
    assert TrackerState.load(q).equals(t.snapshot())


def test_route_queries_track_hook_matches_repro():
    records, work_a, _ = _setup()
    ref_build = rbuild_layout(records, work_a, min_block=100)
    build = build_layout(records, to_port(work_a), min_block=100,
                         device="cpu")
    ref = RefEngine(ref_build.tree, backend="numpy")
    eng = LayoutEngine(build.tree, device="cpu")
    rt = RTracker(SCHEMA, RTrackerConfig(**CFG))
    tt = WorkloadTracker(TSCHEMA, TrackerConfig(**CFG))
    twa = to_port(work_a)
    for g, w in zip(eng.route_queries(twa, track=tt),
                    ref.route_queries(work_a, track=rt)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        eng.route_query(twa.queries[0], track=tt),
        ref.route_query(work_a.queries[0], track=rt))
    # the tensorized overload records the same signatures
    eng.route_queries(twa.tensorize(build.tree.cuts), track=tt)
    ref.route_queries(work_a.tensorize(ref_build.tree.cuts), track=rt)
    assert tt.queries_seen == rt.queries_seen == 2 * len(work_a) + 1
    assert_states_equal(tt.snapshot(), rt.snapshot())


def _auto_loop(svc, tracker, ingest_options, policy, work_a, work_b,
               records):
    with svc.auto_rebuilder(policy) as rebuilder:
        svc.ingest([records[:500]], ingest_options(rebuilder))
        for s in range(500, 2000, 500):
            svc.serve(work_a, tracker=tracker)
            svc.ingest([records[s:s + 500]], ingest_options(rebuilder))
        for s in range(2000, 4000, 500):
            svc.serve(work_b, tracker=tracker)
            svc.ingest([records[s:s + 500]], ingest_options(rebuilder))
    return rebuilder


def test_auto_workload_loop_matches_repro():
    records, work_a, work_b = _setup(7)
    drift = dict(window=4, min_fill=2, abs_threshold=0.5,
                 rel_degradation=None, hysteresis=2, cooldown=4)
    tcfg = dict(n_buckets=256, n_gens=16, decay=0.5)

    rsvc = RefService.build(records[:2000], work_a, strategy="greedy",
                            backend="numpy", min_block=100)
    rt = rsvc.workload_tracker(RTrackerConfig(**tcfg))
    rrb = _auto_loop(rsvc, rt, lambda rb: RIngestOptions(monitor=rb),
                     RPolicy(workload="auto", tracker=rt,
                             drift=RConfig(**drift), reservoir_capacity=4000,
                             executor="sync",
                             rebuild_kw=dict(min_block=100)),
                     work_a, work_b, records)
    twa, twb = to_port(work_a), to_port(work_b)
    tsvc = LayoutService.build(records[:2000], twa, strategy="greedy",
                               device="cpu", min_block=100)
    tt = tsvc.workload_tracker(TrackerConfig(**tcfg))
    trb = _auto_loop(tsvc, tt, lambda rb: IngestOptions(monitor=rb),
                     RebuildPolicy(workload="auto", tracker=tt,
                                   drift=DriftConfig(**drift),
                                   reservoir_capacity=4000, executor="sync",
                                   rebuild_kw=dict(min_block=100)),
                     twa, twb, records)
    assert trb.rebuilds_deployed == rrb.rebuilds_deployed == 1
    assert [(e.observation, e.deployed, e.skipped) for e in trb.events] == [
        (e.observation, e.deployed, e.skipped) for e in rrb.events]
    for te, re_ in zip(trb.events, rrb.events):
        assert dataclasses.asdict(te.decision) == dataclasses.asdict(
            re_.decision)
        assert te.report.build.provenance == re_.report.build.provenance
        assert te.report.candidate_scanned == re_.report.candidate_scanned
    assert tsvc.generation == rsvc.generation
    assert_states_equal(tt.snapshot(), rt.snapshot())
    assert tsvc.skip_stats(records, twb, tighten=False).scanned_tuples == (
        rsvc.skip_stats(records, work_b, tighten=False).scanned_tuples)
