"""The port's serving tier against ``repro.serve`` on the CPU.

The reference's serving tests, each run on both packages from the same
seeded inputs (``device="cpu"`` for the port, the ``numpy`` backend for
the reference): exact signatures equal ``repro.serve.cache.
exact_signatures`` and route identically; the result cache's epoch
lifecycle, LRU and stale-put counters; admission and coalescing; epoch
invalidation by hot swap and by in-place tightening; the stale-read hammer
under concurrent swaps (three client threads, four swaps); tracker
observation of cached traffic; the stats surface.  Sync-mode counters and
responses equal the reference's server bit for bit.  The port's miss path
uploads each batch's conjuncts for that dispatch only: serving builds no
plan and evicts no standing workload's operands.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # tier-1 containers without hypothesis
    from tests._hypothesis_shim import given, settings, st

from repro.core import query as rqry  # noqa: E402
from repro.serve import QueryServer as RServer  # noqa: E402
from repro.serve import RequestQueue as RQueue  # noqa: E402
from repro.serve import ResultCache as RCache  # noqa: E402
from repro.serve import ServeConfig as RConfig  # noqa: E402
from repro.serve import exact_signatures as rsigs  # noqa: E402
from repro.service import Epoch as REpoch  # noqa: E402
from repro.service import LayoutService as RefService  # noqa: E402
from repro.service.tracker import (  # noqa: E402
    query_from_signature as rfrom_sig,
)
from repro_torch.core import query as qry  # noqa: E402
from repro_torch.core.predicates import OP_GE, OP_LT  # noqa: E402
from repro_torch.core.query import InAtom, Query, RangeAtom  # noqa: E402
from repro_torch.engine import LayoutEngine  # noqa: E402
from repro_torch.engine import plan as planlib  # noqa: E402
from repro_torch.engine.backends import get_backend  # noqa: E402
from repro_torch.engine.plan import PlanKey  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    EXACT_RESOLUTION,
    AdmissionError,
    QueryServer,
    RequestQueue,
    ResultCache,
    ServeConfig,
    exact_signatures,
)
from repro_torch.service import Epoch, LayoutService, build_layout  # noqa: E402
from repro_torch.service.tracker import query_from_signature  # noqa: E402
from tests.test_qdtree import small_setup  # noqa: E402
from tests.test_query import random_query  # noqa: E402
from tests.test_torch_woodblock import to_port  # noqa: E402


def _setup(seed=0, n_queries=8):
    """(schema, records, ref cuts, ref workload, port cuts, port workload)."""
    schema, records, cuts = small_setup(seed)
    rng = np.random.default_rng(seed)
    work = rqry.Workload(
        schema, tuple(random_query(schema, rng) for _ in range(n_queries))
    )
    return schema, records, cuts, work, to_port(cuts), to_port(work)


def _services(seed=0, n_queries=8, min_block=30):
    """The reference's service (numpy) and the port's (torch on the CPU)
    over the same greedy build."""
    schema, records, cuts, work, tcuts, twork = _setup(seed, n_queries)
    ref = RefService.build(records, work, strategy="greedy", cuts=cuts,
                           backend="numpy", min_block=min_block)
    port = LayoutService.build(records, twork, strategy="greedy",
                               cuts=tcuts, device="cpu",
                               min_block=min_block)
    return records, (cuts, work, ref), (tcuts, twork, port)


def _sig1(schema, q, cuts=None):
    return exact_signatures(qry.Workload(schema, (q,)), cuts)[0]


def assert_results_equal(port, ref):
    """Served results: the same ids, provenance and cache flags."""
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.bids, r.bids)
        assert (p.generation, p.desc_version, p.replica_id, p.cached) == (
            r.generation, r.desc_version, r.replica_id, r.cached)


def counters_sans_timing(server):
    stats = server.stats()
    stats.pop("latency")
    return stats


# ---------------------------------------------------------------------------
# Exact signatures: the cache-key soundness properties
# ---------------------------------------------------------------------------
@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=10_000))
def test_equal_signatures_route_identically(seed):
    """Two textually different queries whose atoms fold to one canonical
    form share an exact signature (the reference's) and route to
    bit-identical block ids on the port's engine."""
    schema, records, cuts, work, tcuts, twork = _setup(3)
    build = build_layout(records, twork, strategy="greedy", cuts=tcuts,
                         min_block=30, device="cpu")
    tschema = to_port(schema)
    rng = np.random.default_rng(seed)
    lo = int(rng.integers(0, 32))
    hi = lo + int(rng.integers(1, 32))
    a1 = RangeAtom(0, OP_GE, lo)
    a2 = RangeAtom(0, OP_LT, hi)
    a3 = InAtom(2, (0, 2, 4))
    q1 = Query.conjunction([a1, a2, a3])
    q2 = Query.conjunction([a3, a2, a1, RangeAtom(0, OP_GE, lo)])
    s1 = _sig1(tschema, q1, build.tree.cuts)
    s2 = _sig1(tschema, q2, build.tree.cuts)
    assert s1 == s2
    want = rsigs(rqry.Workload(schema, (rqry.Query.conjunction([
        rqry.RangeAtom(0, OP_GE, lo), rqry.RangeAtom(0, OP_LT, hi),
        rqry.InAtom(2, (0, 2, 4))]),)), cuts)[0]
    assert s1 == want
    eng = LayoutEngine(build.tree, device="cpu")
    np.testing.assert_array_equal(eng.route_query(q1), eng.route_query(q2))


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=0, max_value=10_000))
def test_exact_signature_recanonicalization_fixed_point(seed):
    """A query rebuilt from its exact signature re-signs to it, and every
    signature equals the reference's."""
    schema = small_setup(3)[0]
    tschema = to_port(schema)
    rng = np.random.default_rng(seed)
    rq = random_query(schema, rng)
    q = to_port(rq)
    sig = _sig1(tschema, q)
    assert sig == rsigs(rqry.Workload(schema, (rq,)))[0]
    rebuilt = query_from_signature(sig, tschema)
    assert _sig1(tschema, rebuilt) == sig
    assert to_port(rfrom_sig(sig, schema)) == rebuilt
    assert EXACT_RESOLUTION > max(c.dom for c in tschema.columns)


# ---------------------------------------------------------------------------
# ResultCache: epoch keying, LRU, stale-put rejection
# ---------------------------------------------------------------------------
def _cache_lifecycle(cache_cls, epoch_cls):
    cache = cache_cls(capacity=8)
    e1, e2 = epoch_cls(1, 0), epoch_cls(2, 0)
    bids = np.arange(3, dtype=np.int32)
    log = [cache.put(e1, ("sig",), bids)]
    cache.activate(e1)
    log.append(cache.put(e1, ("sig",), bids))
    got = cache.get(e1, ("sig",))
    np.testing.assert_array_equal(got, bids)
    assert not got.flags.writeable
    log.append(cache.activate(e2))
    log.append(len(cache))
    log.append(cache.get(e1, ("sig",)) is None)
    log.append(cache.put(e1, ("sig",), bids))
    with pytest.raises(TypeError):
        cache.get((2, 0), ("sig",))  # a bare tuple is not an Epoch
    return log, cache.snapshot()


def test_result_cache_epoch_lifecycle():
    log, snap = _cache_lifecycle(ResultCache, Epoch)
    assert log == [False, True, 1, 0, True, False]
    assert snap["stale_puts"] == 2 and snap["invalidated"] == 1
    assert snap["epoch_changes"] == 2 and snap["hits"] == 1
    assert (log, snap) == _cache_lifecycle(RCache, REpoch)


def test_result_cache_lru_eviction_and_get_many_parity():
    def run(cache_cls, epoch_cls):
        cache = cache_cls(capacity=2)
        e = epoch_cls(1, 0)
        cache.activate(e)
        for i in range(3):
            cache.put(e, (i,), np.array([i], np.int32))
        assert cache.get(e, (0,)) is None  # oldest evicted
        many = cache.get_many(e, [(1,), (2,), (0,)])
        single = [cache.get(e, s) for s in [(1,), (2,), (0,)]]
        for a, b in zip(many, single):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        return [None if a is None else a.tolist() for a in many], \
            cache.snapshot()

    many, snap = run(ResultCache, Epoch)
    assert many == [[1], [2], None]
    assert snap["evictions"] == 1 and snap["size"] == 2
    assert (many, snap) == run(RCache, REpoch)


def test_result_cache_rejects_bad_capacity():
    with pytest.raises(ValueError):
        ResultCache(capacity=0)
    with pytest.raises(ValueError):
        ServeConfig(max_batch=0)


# ---------------------------------------------------------------------------
# Admission + coalescing
# ---------------------------------------------------------------------------
def test_admission_queue_and_tenant_bounds():
    def run(queue, q):
        reasons = []
        for tenant in ("a", "a", "a", "b", "c", "d"):
            try:
                queue.submit(q, tenant=tenant)
            except Exception as e:  # AdmissionError of either package
                reasons.append(e.reason)
        return reasons, queue.stats.as_dict()

    _, _, _, work, _, twork = _setup(5)
    kw = dict(max_batch=4, max_queue=4, max_per_tenant=2)
    got = run(RequestQueue(ServeConfig(**kw)), twork.queries[0])
    assert got == (["tenant", "queue"], {
        "accepted": 4, "rejected_queue": 1, "rejected_tenant": 1})
    assert got == run(RQueue(RConfig(**kw)), work.queries[0])


def test_submit_many_keeps_admitted_prefix_on_rejection():
    _, _, _, _, _, twork = _setup(5)
    queue = RequestQueue(ServeConfig(max_batch=4, max_queue=3))
    with pytest.raises(AdmissionError):
        queue.submit_many([twork.queries[0]] * 5)
    assert queue.stats.accepted == 3
    assert len(queue) == 3
    batch = queue.next_batch(timeout=0)
    assert len(batch) == 3
    queue.release_many(batch)
    assert queue.inflight("default") == 0


def test_sync_serve_batch_chunks_at_max_batch():
    """19 queries at max_batch 8: three dispatches; every counter, cache
    statistic and response equals the reference server's."""
    _, (_, work, ref), (_, twork, port) = _services(7, n_queries=6)
    idx = [i % len(work) for i in range(8 * 2 + 3)]
    rserver = RServer(ref, RConfig(max_batch=8))
    server = QueryServer(port, ServeConfig(max_batch=8))
    got = server.serve_batch([twork.queries[i] for i in idx])
    want = rserver.serve_batch([work.queries[i] for i in idx])
    assert len(got) == 19
    assert server.counters.dispatches == 3
    assert server.counters.queries_served == 19
    assert_results_equal(got, want)
    assert counters_sans_timing(server) == counters_sans_timing(rserver)
    server.stop()
    rserver.stop()


def test_async_deadline_coalesces_a_trickle():
    _, _, (_, twork, port) = _services(7, n_queries=6)
    server = QueryServer(
        port, ServeConfig(max_batch=32, max_delay_s=0.1)
    ).start()
    tickets = [server.submit(twork.queries[i % 3]) for i in range(3)]
    for t in tickets:
        t.result(timeout=10.0)
    assert server.counters.dispatches == 1
    server.stop()
    with pytest.raises(RuntimeError):
        server.start()


def test_dispatch_failure_reaches_every_ticket(monkeypatch):
    """An engine error in the dispatcher thread fails the batch's tickets
    (each ``result()`` raises it) instead of hanging them."""
    _, _, (_, twork, port) = _services(7, n_queries=6)
    server = QueryServer(port, ServeConfig(max_batch=8)).start()

    def boom(*a, **k):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(get_backend("torch"), "query_intersect", boom)
    tickets = [server.submit(q) for q in twork.queries[:3]]
    for t in tickets:
        with pytest.raises(RuntimeError, match="kernel failed"):
            t.result(timeout=10.0)
    assert server.queue.inflight("default") == 0
    server.stop()


# ---------------------------------------------------------------------------
# Epoch invalidation: hot swap and in-place tighten
# ---------------------------------------------------------------------------
def test_hot_swap_retires_prior_generation_entries():
    records, (cuts, work, ref), (tcuts, twork, port) = _services(11)
    servers = (QueryServer(port, ServeConfig(max_batch=8)),
               RServer(ref, RConfig(max_batch=8)))
    qs = (list(twork.queries[:4]), list(work.queries[:4]))
    runs = []
    for server, svc, q, build, c, w in (
        (servers[0], port, qs[0], build_layout, tcuts, twork),
        (servers[1], ref, qs[1], None, cuts, work),
    ):
        server.serve_batch(q)
        r2 = server.serve_batch(q)
        assert all(r.cached for r in r2)
        old_epoch = svc.live_epoch()
        if build is None:
            from repro.service import build_layout as rbuild

            other = rbuild(records, w, strategy="greedy", cuts=c,
                           min_block=60)
        else:
            other = build(records, w, strategy="greedy", cuts=c,
                          min_block=60, device="cpu")
        gen = svc.swap(other)
        assert server.cache.epoch == svc.live_epoch()
        assert server.cache.stats.invalidated > 0
        assert server.cache.get(old_epoch, ("anything",)) is None
        r3 = server.serve_batch(q)
        assert not any(r.cached for r in r3)
        assert all(r.generation == gen for r in r3)
        runs.append((r2, r3))
        server.stop()
    for (p2, p3), (w2, w3) in zip([runs[0]], [runs[1]]):
        assert_results_equal(p2, w2)
        assert_results_equal(p3, w3)
    for q, r in zip(qs[0], runs[0][1]):
        np.testing.assert_array_equal(
            r.bids, port.version(r.generation).engine.route_query(q))


def test_tighten_bumps_epoch_and_refreshes_results():
    records, (_, work, ref), (_, twork, port) = _services(13)
    got = []
    for svc, server, qs in (
        (port, QueryServer(port, ServeConfig(max_batch=8)),
         list(twork.queries[:4])),
        (ref, RServer(ref, RConfig(max_batch=8)), list(work.queries[:4])),
    ):
        server.serve_batch(qs)
        assert all(r.cached for r in server.serve_batch(qs))
        live = svc.live_version()
        v0 = planlib.desc_version(live.tree)
        live.tree.tighten(records, live.engine.route(records))
        r = server.serve_batch(qs)
        assert not any(x.cached for x in r)
        assert all(x.desc_version == v0 + 1 for x in r)
        for q, x in zip(qs, r):
            np.testing.assert_array_equal(x.bids, live.engine.route_query(q))
        assert all(x.cached for x in server.serve_batch(qs))
        got.append(r)
        server.stop()
    assert_results_equal(*got)


# ---------------------------------------------------------------------------
# Stale-read hammer: swaps under live concurrent traffic
# ---------------------------------------------------------------------------
def test_stale_read_hammer_under_concurrent_swaps():
    records, _, (tcuts, twork, svc) = _services(17, n_queries=10)
    builds = [
        build_layout(records, twork, strategy="greedy", cuts=tcuts,
                     min_block=mb, device="cpu")
        for mb in (40, 70)
    ]
    server = QueryServer(
        svc, ServeConfig(max_batch=8, max_delay_s=0.002)
    ).start()
    pairs = []
    lock = threading.Lock()
    errors = []

    def client(tid):
        rng = np.random.default_rng(100 + tid)
        mine = []
        try:
            for _ in range(40):
                q = twork.queries[int(rng.integers(0, len(twork)))]
                mine.append((q, server.serve(q, tenant=f"t{tid}",
                                             timeout=30.0)))
        except BaseException as e:
            errors.append(e)
        with lock:
            pairs.extend(mine)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for i in range(4):  # hot swaps under live traffic
        time.sleep(0.01)
        svc.swap(builds[i % 2])
    for t in threads:
        t.join()
    server.stop()
    assert not errors, errors[0]
    assert len(pairs) == 120
    assert server.counters.stale_responses == 0
    for q, res in pairs:
        np.testing.assert_array_equal(
            res.bids, svc.version(res.generation).engine.route_query(q)
        )


# ---------------------------------------------------------------------------
# Cached traffic still feeds workload observation
# ---------------------------------------------------------------------------
def test_cache_hits_record_into_tracker():
    records, (_, work, ref), (_, twork, port) = _services(19, n_queries=6)
    states = []
    for svc, cfg_cls, srv_cls, qs in (
        (port, ServeConfig, QueryServer, list(twork.queries[:4])),
        (ref, RConfig, RServer, list(work.queries[:4])),
    ):
        tracker = svc.workload_tracker()
        server = srv_cls(svc, cfg_cls(max_batch=8), tracker=tracker)
        server.serve_batch(qs)
        assert tracker.snapshot().queries_seen == 4
        assert all(x.cached for x in server.serve_batch(qs))
        assert tracker.snapshot().queries_seen == 8
        inferred = tracker.infer_workload()
        assert len(inferred) > 0
        rep = svc.rebuild(records, inferred, min_block=30)
        assert rep.old_generation == 1
        states.append((tracker.snapshot(), rep.swapped, rep.new_generation))
        server.stop()
    (ps, pswap, pgen), (rs, rswap, rgen) = states
    assert (pswap, pgen) == (rswap, rgen)
    assert ps.queries_seen == rs.queries_seen
    assert sorted(ps.counts) == sorted(rs.counts)
    for k, v in rs.counts.items():
        np.testing.assert_array_equal(ps.counts[k], v)


def test_serve_stats_surface():
    _, _, (_, twork, svc) = _services(23)
    tracker = svc.workload_tracker()
    server = QueryServer(svc, ServeConfig(max_batch=8), tracker=tracker)
    server.warm(twork)
    server.serve_batch(list(twork.queries[:3]))
    stats = server.stats()
    assert stats["queue_depth"] == 0
    assert stats["epoch"] == list(svc.live_epoch())
    assert stats["cache"]["lookups"] == 3
    assert stats["latency"]["count"] == 3
    assert stats["counters"]["queries_served"] == 3
    assert stats["admission"]["accepted"] == 3
    res = server.serve(twork.queries[0])
    assert res.epoch == svc.live_epoch()
    server.stop()
    with pytest.raises(RuntimeError):
        server.submit(twork.queries[0])


# ---------------------------------------------------------------------------
# The port's miss path: transient operands, no plan churn
# ---------------------------------------------------------------------------
def _workload_keys(plans):
    with plans._lock:
        return {k for k in plans._plans
                if isinstance(k, PlanKey) and k.opts[:1] == ("workload",)}


def test_serving_builds_no_plan_and_keeps_standing_workloads():
    """After ``warm``, a serving run of many distinct miss batches builds
    no plan of any kind, and the standing workloads' cached operands (the
    service's declared workload and an observation probe's) survive it,
    however many more miss batches than ``WORKLOAD_PLANS`` it routes."""
    records, _, (tcuts, twork, svc) = _services(29, n_queries=10)
    schema = twork.schema
    svc.query_hits(twork)  # the declared workload's operands
    probe_wl = qry.Workload(schema, twork.queries[:3])
    svc.engine.observation_probe(probe_wl)
    standing = _workload_keys(svc.plans)
    assert len(standing) == 2
    server = QueryServer(svc, ServeConfig(max_batch=4))
    server.warm(twork)
    rng = np.random.default_rng(5)
    cap = get_backend("torch").WORKLOAD_PLANS
    before = planlib.build_counts()
    batches = [
        [to_port(random_query(small_setup(0)[0], rng)) for _ in range(4)]
        for _ in range(cap + 4)
    ]
    for b in batches:
        server.serve_batch(b)
    assert server.counters.engine_dispatches >= cap + 1
    assert planlib.build_delta(before, planlib.build_counts()) == {}
    assert _workload_keys(svc.plans) == standing
    # and the responses are the engine's routes
    for b in batches[-2:]:
        for q, r in zip(b, server.serve_batch(b)):
            np.testing.assert_array_equal(r.bids,
                                          svc.engine.route_query(q))
    server.stop()


def test_route_query_builds_no_workload_plan():
    """An ad-hoc ``route_query`` uploads its one query for that launch
    only: no ``workload:torch`` build, no standing workload evicted."""
    _, _, (_, twork, svc) = _services(31, n_queries=6)
    eng = svc.engine
    eng.query_hits(twork)
    standing = _workload_keys(eng.plans)
    before = planlib.build_counts()
    rng = np.random.default_rng(9)
    schema = small_setup(0)[0]
    for _ in range(get_backend("torch").WORKLOAD_PLANS + 2):
        q = random_query(schema, rng)
        np.testing.assert_array_equal(
            eng.route_query(to_port(q)),
            eng.route_query(to_port(q), backend="numpy"))
    assert planlib.build_delta(before, planlib.build_counts()) == {}
    assert _workload_keys(eng.plans) == standing


def test_zipf_mix_sync_rounds_equal_the_reference():
    """A Zipf mix served in sync rounds with a hot swap in the middle:
    every response and every counter equals the reference server's."""
    from repro_torch.launch.serve import zipf_mix

    records, (cuts, work, ref), (tcuts, twork, port) = _services(
        37, n_queries=12)
    from repro.service import build_layout as rbuild

    other = (build_layout(records, twork, cuts=tcuts, min_block=60,
                          device="cpu"),
             rbuild(records, work, cuts=cuts, min_block=60))
    mix = zipf_mix(work, 160, 1.1, 3)
    pos = [work.queries.index(q) for q in mix]
    got, want = [], []
    server = QueryServer(port, ServeConfig(max_batch=16))
    rserver = RServer(ref, RConfig(max_batch=16))
    for r in range(10):
        if r == 5:
            port.swap(other[0])
            ref.swap(other[1])
        chunk = pos[r * 16:(r + 1) * 16]
        got += server.serve_batch([twork.queries[i] for i in chunk])
        want += rserver.serve_batch([work.queries[i] for i in chunk])
    assert_results_equal(got, want)
    assert counters_sans_timing(server) == counters_sans_timing(rserver)
    assert server.counters.stale_responses == 0
    server.stop()
    rserver.stop()
