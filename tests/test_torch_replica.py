"""The port's replica sets against ``repro.service.replica`` on the CPU.

Clustering, blended mixes, deployed replica sets, cheapest-replica
routing (the engines' ``query_intersect``), per-replica rollback and
``rebuild_replicas`` equal the reference's exactly; the typed
``IngestOptions`` surface behaves as the reference's does.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import query as rqry  # noqa: E402
from repro.service import LayoutService as RefService  # noqa: E402
from repro.service import build_layout as rbuild_layout  # noqa: E402
from repro.service import replica as rreplica  # noqa: E402
from repro_torch.engine import LayoutEngine  # noqa: E402
from repro_torch.service import (  # noqa: E402
    Epoch,
    IngestOptions,
    LayoutService,
    RebuildPolicy,
    ReplicaSet,
    build_layout,
)
from repro_torch.service import replica as treplica  # noqa: E402
from tests.test_qdtree import small_setup  # noqa: E402
from tests.test_query import random_query  # noqa: E402
from tests.test_replica import _split_workload  # noqa: E402
from tests.test_torch_engine import _arrays  # noqa: E402
from tests.test_torch_woodblock import to_port  # noqa: E402


def _setup(seed=0, n_queries=8):
    schema, records, cuts = small_setup(seed)
    rng = np.random.default_rng(seed)
    work = rqry.Workload(
        schema, tuple(random_query(schema, rng) for _ in range(n_queries))
    )
    return schema, records, cuts, work


def _services(seed, n_queries=8, min_block=30):
    """The same greedy layout served by both packages."""
    schema, records, cuts, work = _setup(seed, n_queries)
    ref = RefService.build(records, work, strategy="greedy", cuts=cuts,
                           backend="numpy", min_block=min_block)
    svc = LayoutService.build(records, to_port(work), strategy="greedy",
                              cuts=to_port(cuts), device="cpu",
                              min_block=min_block)
    return schema, records, cuts, work, ref, svc


def _deploy_two(ref, svc, records, cuts, work, order=(0, 1), min_block=30):
    subs = _split_workload(work, 2)
    rb = [rbuild_layout(records, s, strategy="greedy", cuts=cuts,
                        min_block=min_block) for s in subs]
    tb = [build_layout(records, to_port(s), strategy="greedy",
                       cuts=to_port(cuts), min_block=min_block,
                       device="cpu") for s in subs]
    return (ref.deploy_replicas([rb[i] for i in order]),
            svc.deploy_replicas([tb[i] for i in order]))


def assert_routes_equal(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert (p.replica_id, p.cost) == (r.replica_id, r.cost)
        np.testing.assert_array_equal(p.bids, r.bids)
        assert p.bids.dtype == r.bids.dtype


def test_epochs_and_k1_routing_match_repro():
    schema, records, cuts, work, ref, svc = _services(2)
    assert svc.live_epoch() == Epoch(*ref.live_epoch())
    assert isinstance(svc.live_epochs()[0], Epoch)
    assert svc.live_replica_set().k == 1
    twork = to_port(work)
    assert_routes_equal(svc.route_queries_cheapest(twork),
                        ref.route_queries_cheapest(work))
    # k = 1: the plain batched route_queries answer
    for r, bids in zip(svc.route_queries_cheapest(twork),
                       svc.route_queries(twork)):
        np.testing.assert_array_equal(r.bids, bids)


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
@pytest.mark.parametrize("seed", [4, 9])
def test_cheapest_routing_of_two_replicas_matches_repro(seed, order):
    schema, records, cuts, work, ref, svc = _services(seed, n_queries=10)
    rset, tset = _deploy_two(ref, svc, records, cuts, work, order)
    assert tset.generations() == rset.generations()
    assert [e for e in tset.epochs()] == [Epoch(*e) for e in rset.epochs()]
    for tb, rb in zip(tset.block_sizes, rset.block_sizes):
        np.testing.assert_array_equal(tb, rb)
    rng = np.random.default_rng(seed)
    probe = rqry.Workload(
        schema, tuple(random_query(schema, rng) for _ in range(8)))
    assert_routes_equal(svc.route_queries_cheapest(to_port(probe)),
                        ref.route_queries_cheapest(probe))
    assert tset.scanned_fraction(to_port(probe), records.shape[0]) == (
        rset.scanned_fraction(probe, records.shape[0]))
    assert tset.describe() == rset.describe()


def test_clustering_and_mixes_match_repro():
    schema, _, _, work = _setup(14, n_queries=12)
    items = rreplica.workload_signature_weights(work)
    assert treplica.workload_signature_weights(to_port(work)) == items
    tschema = to_port(schema)
    for k in (1, 2, 3, 5):
        assert treplica.cluster_signatures(items, tschema, k) == (
            rreplica.cluster_signatures(items, schema, k))
    for sig, _ in items:
        np.testing.assert_array_equal(
            treplica.signature_features(sig, tschema),
            rreplica.signature_features(sig, schema))
    cluster = list(range(len(items) // 2))
    for lam in (0.0, 0.25, 1.0):
        assert treplica.blended_mix(items, cluster, lam) == (
            rreplica.blended_mix(items, cluster, lam))
    twls, tsigs = treplica.cluster_workloads(items, tschema, 2, lam=0.25,
                                             budget=32)
    rwls, rsigs = rreplica.cluster_workloads(items, schema, 2, lam=0.25,
                                             budget=32)
    assert tsigs == rsigs
    assert [w.queries for w in twls] == [to_port(w.queries) for w in rwls]


def test_rollback_and_release_per_replica_match_repro():
    schema, records, cuts, work, ref, svc = _services(13)
    _deploy_two(ref, svc, records, cuts, work)
    (_, g1_old) = svc.live_replica_set().generations()
    _deploy_two(ref, svc, records, cuts, work, min_block=40)
    assert svc.rollback(g1_old) == ref.rollback(g1_old)
    assert svc.replica_generations() == ref.replica_generations()
    assert svc.rollback() == ref.rollback()
    assert svc.replica_generations() == ref.replica_generations()
    assert svc.versions() == ref.versions()
    g0, g1 = svc.replica_generations()
    with pytest.raises(ValueError, match="serving as replica 1"):
        svc.release(g1)
    with pytest.raises(ValueError, match=r"held by replica r0.*r1"):
        svc.release(999)
    live = svc.live_version()
    with pytest.raises(ValueError, match="ids must match positions"):
        ReplicaSet((live, live))
    with pytest.raises(ValueError, match="not in live set"):
        svc.live_replica_set().replace(3, live)


def test_rebuild_replicas_matches_repro():
    schema, records, cuts, work, ref, svc = _services(16, n_queries=12)
    kw = dict(k=2, lam=0.25, swap="always", min_block=30)
    rrep = ref.rebuild_replicas(records, workload=work, cuts=cuts, **kw)
    trep = svc.rebuild_replicas(records, workload=to_port(work),
                                cuts=to_port(cuts), **kw)
    for f in ("k", "lam", "clusters", "candidate_scanned", "live_scanned",
              "swapped", "old_generations", "new_generations"):
        assert getattr(trep, f) == getattr(rrep, f), f
    for tb, rb in zip(trep.builds, rrep.builds):
        want = _arrays(rb.tree)
        for k, v in tb.tree.to_arrays().items():
            np.testing.assert_array_equal(v, want[k], k)
    assert svc.live_version() is svc.live_replica_set().primary
    with pytest.raises(ValueError, match="invalid swap policy"):
        svc.rebuild_replicas(records, workload=to_port(work),
                             swap="sometimes")
    with pytest.raises(ValueError, match="needs a tracker"):
        svc.rebuild_replicas(records, workload=None)


def test_tracker_driven_replicas_route_like_numpy():
    """Replicas clustered from a tracker's served mix: each query's
    cheapest route equals the numpy route of the chosen replica's tree."""
    schema, records, cuts, work, ref, svc = _services(18, n_queries=12)
    twork = to_port(work)
    tracker = svc.workload_tracker()
    for _ in range(3):
        svc.serve(twork, tracker=tracker)
    rep = svc.rebuild_replicas(records, k=2, swap="always",
                               tracker=tracker, cuts=to_port(cuts),
                               min_block=30)
    assert rep.swapped
    rset = svc.live_replica_set()
    assert rset.k == len(rep.builds) == 2
    for q, r in zip(twork.queries, svc.route_queries_cheapest(twork)):
        tree = rset.versions[r.replica_id].tree
        oracle = LayoutEngine(tree, backend="numpy", device="cpu")
        np.testing.assert_array_equal(r.bids, oracle.route_query(q))
        assert r.cost == int(rset.block_sizes[r.replica_id][r.bids].sum())


def test_ingest_options_surface():
    """One ingest entry point takes the typed options: a sharded ingest
    equals the reference's at its default batch (2048 on the CPU), a batch
    iterable is refused for shards, bad values raise, and a policy yields
    a rebuilder."""
    from repro.service import IngestOptions as RIngestOptions

    schema, records, cuts, work, ref, svc = _services(17)
    assert svc.ingest_batch(IngestOptions()) == RIngestOptions().batch
    assert svc.ingest_batch(IngestOptions(batch=57)) == 57
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rrep = ref.ingest(records, RIngestOptions(shards=2,
                                                  executor="thread"))
        rep = svc.ingest(records, IngestOptions(shards=2, executor="thread"))
    assert rep.n_records == len(records) and rep.n_shards == 2
    assert (rep.n_batches, rep.n_shards) == (rrep.n_batches, rrep.n_shards)
    np.testing.assert_array_equal(rep.block_sizes, rrep.block_sizes)
    with pytest.raises(TypeError, match="record array"):
        svc.ingest([records], IngestOptions(shards=2))
    for bad in (dict(shards=0), dict(batch=0)):
        with pytest.raises(ValueError):
            IngestOptions(**bad)
    rb = svc.auto_rebuilder(RebuildPolicy(workload=to_port(work),
                                          replicas=2, lam=0.5))
    assert rb.policy.replicas == 2 and rb.policy.lam == 0.5
    rb.close()


@pytest.mark.parametrize("k,batch", [(2, 16), (3, 57)])
def test_sharded_service_ingest_matches_repro(k, batch):
    schema, records, cuts, work = _setup(21)
    half = records[: len(records) // 2]
    ref = RefService.build(half, work, strategy="greedy", cuts=cuts,
                           backend="numpy", min_block=30)
    svc = LayoutService.build(half, to_port(work), strategy="greedy",
                              cuts=to_port(cuts), device="cpu", min_block=30)
    from repro.service import IngestOptions as RIngestOptions

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rrep = ref.ingest(records, RIngestOptions(shards=k, batch=batch,
                                                  executor="thread"))
        trep = svc.ingest(records, IngestOptions(shards=k, batch=batch,
                                                 executor="thread"))
    assert (trep.n_records, trep.n_batches, trep.n_shards) == (
        rrep.n_records, rrep.n_batches, rrep.n_shards)
    np.testing.assert_array_equal(trep.block_sizes, rrep.block_sizes)
    want = _arrays(ref.tree)
    for key in ("leaf_lo", "leaf_hi", "leaf_cat", "leaf_adv"):
        np.testing.assert_array_equal(getattr(svc.tree, key), want[key])
