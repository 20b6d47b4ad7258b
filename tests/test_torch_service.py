"""The port's layout service against ``repro.service`` on the CPU.

Every build of ``greedy``/``bottom_up``/``random``/``range`` through
``build_layout`` is array-equal to the reference's (tree arrays, bids,
Eq. 1), and its Eq. 1 hit matrix, taken from the build's engine, equals
the numpy hits.  Swap, rollback and release sequences leave the same
generations and route the same ids as the reference's service.  The
reference's thread hammers are kept: CAS swap under concurrent routing,
and a release during a thread-sharded ingest.
"""

import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import query as rqry  # noqa: E402
from repro.core.qdtree import FrozenQdTree as RTree  # noqa: E402
from repro.core.qdtree import IncrementalTightener as RTightener  # noqa: E402
from repro.service import LayoutService as RefService  # noqa: E402
from repro.service import build_layout as rbuild_layout  # noqa: E402
from repro_torch.core import rewards as trewards  # noqa: E402
from repro_torch.engine import LayoutEngine  # noqa: E402
from repro_torch.engine import plan as tplan  # noqa: E402
from repro_torch.engine import sharded as tsharded  # noqa: E402
from repro_torch.engine.plan import PlanKey  # noqa: E402
from repro_torch.service import (  # noqa: E402
    IngestOptions,
    LayoutBuild,
    LayoutService,
    available_strategies,
    build_layout,
    get_builder,
)
from tests.test_qdtree import small_setup  # noqa: E402
from tests.test_query import random_query  # noqa: E402
from tests.test_torch_engine import _arrays  # noqa: E402
from tests.test_torch_woodblock import to_port  # noqa: E402

HOST_STRATEGIES = {
    "greedy": {},
    "bottom_up": {},
    "random": {},
    "range": dict(column=0),
}


def setup(seed=0, n_queries=8):
    """(records, reference cuts and workload, port cuts and workload)."""
    schema, records, cuts = small_setup(seed)
    rng = np.random.default_rng(seed)
    work = rqry.Workload(
        schema, tuple(random_query(schema, rng) for _ in range(n_queries))
    )
    return records, cuts, work, to_port(cuts), to_port(work)


def cpu_service(records, work, cuts, **kw):
    return LayoutService.build(records, work, cuts=cuts, device="cpu", **kw)


def assert_builds_equal(port, ref):
    want = _arrays(ref.tree)
    got = port.tree.to_arrays()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    np.testing.assert_array_equal(port.bids, ref.bids)
    assert port.scanned_fraction == ref.scanned_fraction
    assert port.n_leaves == ref.n_leaves


def test_registry_covers_all_strategies():
    assert set(available_strategies()) == {
        "greedy", "woodblock", "bottom_up", "random", "range"}
    for name in available_strategies():
        assert get_builder(name).name == name
    with pytest.raises(ValueError, match="unknown strategy"):
        get_builder("kd_tree")
    records, _, _, tcuts, twork = setup()
    with pytest.raises(TypeError, match="unknown config keys"):
        build_layout(records, twork, strategy="greedy", cuts=tcuts,
                     min_block=30, episodes_per_iter=4, device="cpu")


@pytest.mark.parametrize("strategy", sorted(HOST_STRATEGIES))
@pytest.mark.parametrize("seed", [3, 8])
def test_build_layout_matches_repro(strategy, seed):
    records, cuts, work, tcuts, twork = setup(seed)
    kw = dict(strategy=strategy, min_block=30, seed=seed,
              **HOST_STRATEGIES[strategy])
    ref = rbuild_layout(records, work, cuts=cuts, **kw)
    port = build_layout(records, twork, cuts=tcuts, device="cpu", **kw)
    assert isinstance(port, LayoutBuild) and port.strategy == strategy
    assert_builds_equal(port, ref)
    assert port.provenance == ref.provenance
    # the Eq. 1 hits come from the build's engine: equal to the numpy hits
    wt = twork.tensorize(port.tree.cuts)
    np.testing.assert_array_equal(
        LayoutEngine(port.tree, device="cpu").query_hits(wt),
        trewards.block_query_hits(port.tree, wt),
    )


def test_build_layout_default_cuts_and_min_block(tpch_small):
    schema, records, work, _ = tpch_small
    ref = rbuild_layout(records[:3000], work)
    port = build_layout(records[:3000], to_port(work), device="cpu")
    assert_builds_equal(port, ref)


def test_woodblock_strategy_builds_a_tightened_layout():
    records, cuts, work, tcuts, twork = setup(3)
    build = build_layout(records, twork, strategy="woodblock", cuts=tcuts,
                         min_block=30, n_iters=2, episodes_per_iter=2,
                         device="cpu")
    assert build.strategy == "woodblock" and build.n_leaves >= 1
    np.testing.assert_array_equal(build.bids, build.tree.route(records))
    assert 0.0 <= build.scanned_fraction <= 1.0
    assert build.metrics["n_episodes"] == 4
    stats = LayoutEngine(build.tree, device="cpu").skip_stats(
        records, twork, tighten=False)
    assert stats.scanned_fraction == build.scanned_fraction


def test_evaluate_layout_follows_the_engine_backend(monkeypatch):
    """``evaluate_layout`` scores on the engine's own backend (torch),
    not the numpy oracle, unless asked."""
    from repro_torch.engine import backends as tbe

    records, cuts, work, tcuts, twork = setup(5)
    build = build_layout(records, twork, cuts=tcuts, min_block=30,
                         device="cpu")
    calls = []
    for name in ("torch", "numpy"):
        be = tbe.get_backend(name)
        orig = be.query_intersect

        def spy(*a, _name=name, _orig=orig, **k):
            calls.append(_name)
            return _orig(*a, **k)

        monkeypatch.setattr(be, "query_intersect", spy)
    tree = build.tree
    got = trewards.evaluate_layout(tree, records, twork, tighten=False,
                                   device="cpu")
    assert calls == ["torch"]
    want = trewards.evaluate_layout(tree, records, twork, tighten=False,
                                    backend="numpy")
    assert calls == ["torch", "numpy"]
    assert got.scanned_tuples == want.scanned_tuples
    np.testing.assert_array_equal(got.query_hits, want.query_hits)


def test_route_queries_and_route_query_match_repro():
    records, cuts, work, tcuts, twork = setup(7, n_queries=12)
    ref = RefService.build(records, work, cuts=cuts, min_block=30,
                           backend="numpy")
    svc = cpu_service(records, twork, tcuts, min_block=30)
    got = svc.route_queries(twork)
    want = ref.route_queries(work)
    assert len(got) == len(want) == len(twork)
    for g, w, q in zip(got, want, twork.queries):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(svc.route_query(q), w)
    np.testing.assert_array_equal(svc.route(records), ref.route(records))
    assert svc.stats()["backend"] == "torch"
    assert svc.stats()["device"] == "cpu"


def test_swap_rollback_release_match_repro():
    """The same lifecycle on both services: equal generations, retained
    versions and routes after every step."""
    records, cuts, work, tcuts, twork = setup(13)
    ref = RefService.build(records, work, cuts=cuts, min_block=60,
                           backend="numpy")
    svc = cpu_service(records, twork, tcuts, min_block=60)

    def same():
        assert svc.generation == ref.generation
        assert svc.versions() == ref.versions()
        assert svc.replica_generations() == ref.replica_generations()
        np.testing.assert_array_equal(svc.route(records), ref.route(records))
        for g, w in zip(svc.route_queries(twork), ref.route_queries(work)):
            np.testing.assert_array_equal(g, w)

    same()
    r_rep = ref.rebuild(records, work, cuts=cuts, min_block=30,
                        swap="always")
    t_rep = svc.rebuild(records, twork, cuts=tcuts, min_block=30,
                        swap="always")
    assert (t_rep.swapped, t_rep.old_generation, t_rep.new_generation) == (
        r_rep.swapped, r_rep.old_generation, r_rep.new_generation)
    assert t_rep.candidate_scanned == r_rep.candidate_scanned
    assert t_rep.live_scanned == r_rep.live_scanned
    same()
    r_rand = ref.rebuild(records, work, strategy="random", cuts=cuts,
                         min_block=30)
    t_rand = svc.rebuild(records, twork, strategy="random", cuts=tcuts,
                         min_block=30)
    assert t_rand.swapped == r_rand.swapped
    same()
    assert svc.rollback() == ref.rollback()
    same()
    assert svc.rollback(t_rep.new_generation) == ref.rollback(
        r_rep.new_generation)
    same()
    # release evicts the old generation's plans (the numpy reference
    # caches none of its own on this path)
    old_sig = tplan.tree_signature(svc.version(1).tree)
    n_old = sum(1 for k in svc.plans._plans
                if isinstance(k, PlanKey) and k.sig == old_sig)
    assert n_old > 0
    ref.release(1)
    assert svc.release(1) == n_old
    same()
    for s, r in ((svc, ref),):
        with pytest.raises(ValueError, match="cannot release the live"):
            s.release(s.generation)
        with pytest.raises(ValueError, match=r"generation 99.*retained"):
            s.rollback(99)
        with pytest.raises(ValueError, match="unknown or released"):
            s.rollback(1)


def test_rebuild_if_better_and_stale_safe():
    records, cuts, work, tcuts, twork = setup(29)
    svc = cpu_service(records, twork, tcuts, min_block=30,
                      strategy="random")
    racing = build_layout(records, twork, cuts=tcuts, min_block=30,
                          device="cpu")

    def concurrent_swap(candidate):
        svc.swap(racing)

    report = svc.rebuild(records, twork, strategy="greedy", cuts=tcuts,
                         min_block=40, on_candidate=concurrent_swap)
    assert report.candidate_scanned < report.live_scanned
    assert not report.swapped and svc.tree is racing.tree
    with pytest.raises(ValueError, match="invalid swap policy"):
        svc.rebuild(records, twork, cuts=tcuts, swap="maybe")


def test_swap_if_live_is_one_winner_per_baseline_under_concurrent_route():
    """CAS hammer: concurrent deploys against one observed baseline admit
    exactly one winner a round, while other threads keep routing the live
    tree and get the numpy route of whichever generation they read."""
    records, cuts, work, tcuts, twork = setup(53)
    svc = cpu_service(records, twork, tcuts, min_block=30)
    candidates = [
        build_layout(records, twork, strategy="random", cuts=tcuts,
                     min_block=30, seed=s, device="cpu")
        for s in range(8)
    ]
    stop = threading.Event()
    errors = []

    def router():
        while not stop.is_set():
            v = svc.live_version()
            got = v.engine.route(records[:200])
            if not np.array_equal(got, v.tree.route(records[:200])):
                errors.append(v.generation)

    routers = [threading.Thread(target=router) for _ in range(3)]
    for t in routers:
        t.start()
    try:
        with ThreadPoolExecutor(max_workers=8) as pool:
            for _ in range(5):
                baseline = svc.live_version()
                got = list(pool.map(
                    lambda b: svc._swap_if_live_is(baseline, b), candidates
                ))
                wins = [g for g in got if g is not None]
                assert len(wins) == 1
                assert svc.generation == wins[0]
    finally:
        stop.set()
        for t in routers:
            t.join()
    assert not errors


def _oracle_state(tree, records):
    """The numpy tightening aggregates of ``records`` on a tree."""
    t = RTightener(tree)
    t.update(records, tree.route(records))
    return t


def test_release_during_thread_sharded_ingest(monkeypatch):
    """A generation swapped out and released while its thread-sharded
    ingest runs: the run is stale (not published), and its merged state
    equals the numpy oracle's over the same records."""
    records, cuts, work, tcuts, twork = setup(61)
    records = np.concatenate([records] * 4)
    svc = cpu_service(records, twork, tcuts, min_block=60)
    old = svc.live_version()
    started, go = threading.Event(), threading.Event()
    orig = tsharded._run_shard

    def gated(ingestor, batches):
        started.set()
        assert go.wait(10)
        return orig(ingestor, batches)

    monkeypatch.setattr(tsharded, "_run_shard", gated)
    out = []

    def run():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", tsharded.PerformanceWarning)
            out.append(svc.ingest(
                records, IngestOptions(shards=4, executor="thread",
                                       batch=97),
                keep_state=True,
            ))

    t = threading.Thread(target=run)
    t.start()
    assert started.wait(10)
    new_gen = svc.swap(build_layout(records, twork, cuts=tcuts,
                                    min_block=30, device="cpu"))
    assert svc.release(old.generation) > 0
    go.set()
    t.join(30)
    assert not t.is_alive()
    (rep,) = out
    assert rep.stale_generation and not rep.published
    assert svc.generation == new_gen
    want = _oracle_state(RTree.load(_npz(old.tree)), records)
    state = rep.state
    for f in ("counts", "lo", "hi", "cat", "adv"):
        np.testing.assert_array_equal(getattr(state, f), getattr(want, f), f)
    assert state.n_records == records.shape[0]


def _npz(tree):
    import io

    buf = io.BytesIO()
    tree.save(buf)
    buf.seek(0)
    return buf


def test_apply_partial_and_service_adopts_bare_tree():
    records, cuts, work, tcuts, twork = setup(23)
    build = build_layout(records, twork, cuts=tcuts, min_block=30,
                         device="cpu")
    svc = LayoutService(build.tree, device="cpu")
    assert svc.version(svc.generation).build.strategy == "adopted"
    np.testing.assert_array_equal(svc.route(records),
                                  build.tree.route(records))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", tsharded.PerformanceWarning)
        rep = svc.ingest(records, IngestOptions(shards=2, executor="thread"),
                         tighten=False, keep_state=True)
    live = svc.live_version()
    assert svc.apply_partial(rep.state, expected=live)
    assert not svc.apply_partial(rep.state, expected=object())
    np.testing.assert_array_equal(svc.tree.block_sizes, rep.block_sizes)


def test_serve_tracks_and_ticks():
    from repro.service import WorkloadTracker as RefTracker

    records, cuts, work, tcuts, twork = setup(31)
    ref = RefService.build(records, work, cuts=cuts, min_block=30,
                           backend="numpy")
    svc = cpu_service(records, twork, tcuts, min_block=30)
    rt, tt = ref.workload_tracker(), svc.workload_tracker()
    assert isinstance(rt, RefTracker)
    for _ in range(3):
        for g, w in zip(svc.serve(twork, tracker=tt),
                        ref.serve(work, tracker=rt)):
            np.testing.assert_array_equal(g, w)
    svc.route_query(twork.queries[0], track=tt)
    ref.engine.route_query(work.queries[0], track=rt)
    assert tt.snapshot().generation == rt.snapshot().generation == 3
    assert tt.queries_seen == rt.queries_seen
    assert tt.top_signatures(8) == rt.top_signatures(8)
