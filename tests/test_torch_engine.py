"""The port's main path against the JAX package, end to end on the CPU.

A tree built by ``repro`` carries over through ``from_arrays`` (or its
``.npz``); the port's LayoutEngine on ``device="cpu"`` (the kernels'
plain versions) then routes, fuses and ingests with block ids and
tightened descriptions equal to ``repro``'s, and answers queries equal to
``repro``'s ``jax`` backend.  The port's data generators and greedy
builder give array-equal records, workloads and trees.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import greedy as rgreedy  # noqa: E402
from repro.engine import LayoutEngine as JaxEngine  # noqa: E402
from repro_torch.core import greedy as tgreedy  # noqa: E402
from repro_torch.core import query as tqry  # noqa: E402
from repro_torch.core import rewards as trewards  # noqa: E402
from repro_torch.core.qdtree import FrozenQdTree as TorchTree  # noqa: E402
from repro_torch.data import datagen as tdatagen  # noqa: E402
from repro_torch.data import workload as twl  # noqa: E402
from repro_torch.engine import LayoutEngine, build_counts  # noqa: E402
from repro_torch.engine.backends import get_backend  # noqa: E402
from tests.test_qdtree import random_tree, small_setup  # noqa: E402
from tests.test_query import random_query  # noqa: E402
from tests.test_torch_kernels import (  # noqa: E402
    carry_tree,
    carry_wt,
    uneven_batches,
)

SEEDS = [0, 3, 11]
LEAF_FIELDS = ("leaf_lo", "leaf_hi", "leaf_cat", "leaf_adv")


def _arrays(tree) -> dict:
    """The ``save`` keys of a ``repro`` tree, as a dict of arrays."""
    import io

    buf = io.BytesIO()
    tree.save(buf)
    buf.seek(0)
    with np.load(buf) as z:
        return dict(z)


def _port_query(q):
    """A ``repro`` query rebuilt from the port's atom classes."""
    return tqry.Query(conjuncts=tuple(
        tuple(getattr(tqry, type(a).__name__)(**dataclasses.asdict(a))
              for a in conj)
        for conj in q.conjuncts
    ))


def _case(seed):
    schema, records, cuts = small_setup(seed, m=900)
    rng = np.random.default_rng(seed)
    frozen = random_tree(schema, cuts, records, rng, max_splits=14).freeze()
    return frozen, records, rng


def _assert_trees_equal(port, ref):
    for f in LEAF_FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), f)


@pytest.mark.parametrize("seed", SEEDS)
def test_route_and_fused_step_match_repro(seed):
    frozen, records, _ = _case(seed)
    port = TorchTree.from_arrays(_arrays(frozen))
    eng = LayoutEngine(port, device="cpu")
    ref = JaxEngine(frozen, backend="jax")
    want = ref.route(records)
    np.testing.assert_array_equal(eng.route(records), want)
    # tensors on the engine's device are taken as they are
    np.testing.assert_array_equal(
        eng.route(torch.from_numpy(records)), want
    )
    bids, part = eng.fused_step(records)
    rbids, rpart = ref.fused_step(records)
    np.testing.assert_array_equal(bids, rbids)
    for f in ("counts", "lo", "hi", "cat", "adv"):
        np.testing.assert_array_equal(getattr(part, f), getattr(rpart, f), f)


@pytest.mark.parametrize("seed", SEEDS)
def test_multi_batch_ingest_matches_repro(seed):
    frozen, records, rng = _case(seed)
    port = carry_tree(frozen)
    cuts = np.sort(rng.choice(np.arange(1, records.shape[0]), 4,
                              replace=False))
    batches = np.split(records, cuts)
    eng = LayoutEngine(port, device="cpu")
    eng.warm_ingest({b.shape[0] for b in batches})
    report = eng.ingest(batches)
    ref = JaxEngine(frozen, backend="jax").ingest(batches)
    assert report.fused and report.n_records == records.shape[0]
    assert report.builds == {}  # warm: no plan built during the stream
    np.testing.assert_array_equal(report.block_sizes, ref.block_sizes)
    _assert_trees_equal(port, frozen)
    np.testing.assert_array_equal(port.block_sizes, ref.block_sizes)


@pytest.mark.parametrize("n_batches", [1, 3, 7])
@pytest.mark.parametrize("seed", SEEDS)
def test_ingest_running_fold_matches_repro_engine(seed, n_batches):
    """One running accumulator over uneven batches (one a single row)
    leaves the tree ``repro``'s engine leaves; the per-batch block ids
    that ``observe`` needs come back too."""
    from repro.core import query as rqry

    frozen, records, rng = _case(seed)
    batches = uneven_batches(records, n_batches, rng)
    queries = tuple(random_query(frozen.schema, rng) for _ in range(4))
    rwork = rqry.Workload(frozen.schema, queries)
    port = carry_tree(frozen)
    seen = []
    report = LayoutEngine(port, device="cpu").ingest(
        batches, observe=carry_wt(rwork.tensorize(frozen.cuts)),
        on_observation=seen.append,
    )
    ref = JaxEngine(frozen, backend="jax").ingest(batches, observe=rwork)
    assert report.fused and report.n_batches == n_batches
    assert len(seen) == n_batches
    np.testing.assert_array_equal(report.block_sizes, ref.block_sizes)
    _assert_trees_equal(port, frozen)
    np.testing.assert_array_equal(port.block_sizes, ref.block_sizes)
    assert report.observation.to_array().tolist() == (
        ref.observation.to_array().tolist()
    )


@pytest.mark.parametrize("fused", [True, False])
def test_two_pass_ingest_and_observation_match_fused(fused):
    frozen, records, rng = _case(5)
    work_queries = tuple(
        random_query(frozen.schema, rng) for _ in range(6)
    )
    from repro.core import query as rqry

    wt = carry_wt(rqry.Workload(frozen.schema, work_queries)
                  .tensorize(frozen.cuts))
    port = carry_tree(frozen)
    seen = []
    report = LayoutEngine(port, device="cpu").ingest(
        np.array_split(records, 3), fused=fused, observe=wt,
        on_observation=seen.append,
    )
    ref = JaxEngine(frozen, backend="numpy").ingest(
        np.array_split(records, 3), observe=rqry.Workload(
            frozen.schema, work_queries
        ),
    )
    _assert_trees_equal(port, frozen)
    assert len(seen) == 3
    assert report.observation.to_array().tolist() == (
        ref.observation.to_array().tolist()
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_query_paths_match_jax_backend(seed):
    from repro.core import query as rqry

    frozen, records, rng = _case(seed)
    queries = tuple(random_query(frozen.schema, rng) for _ in range(8))
    rwork = rqry.Workload(frozen.schema, queries)
    port = carry_tree(frozen)
    ref = JaxEngine(frozen, backend="jax")
    eng = LayoutEngine(port, device="cpu")
    want = ref.skip_stats(records, rwork)
    wt = carry_wt(rwork.tensorize(frozen.cuts))
    got = eng.skip_stats(records, wt)
    assert got.scanned_tuples == want.scanned_tuples
    np.testing.assert_array_equal(got.block_sizes, want.block_sizes)
    np.testing.assert_array_equal(got.query_hits, want.query_hits)
    _assert_trees_equal(port, frozen)
    np.testing.assert_array_equal(eng.query_hits(wt), ref.query_hits(rwork))
    for a, b in zip(eng.route_queries(wt), ref.route_queries(rwork)):
        np.testing.assert_array_equal(a, b)
    # the per-conjunct scan counts use the real block sizes
    conj = LayoutEngine(port, backend="numpy", device="cpu")
    np.testing.assert_array_equal(
        got.conj_scanned, conj.skip_stats(records, wt).conj_scanned
    )
    assert got.conj_scanned.sum() > 0
    # the one-query path equals the batched one
    np.testing.assert_array_equal(
        eng.route_query(_port_query(queries[0])), eng.route_queries(wt)[0]
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_route_query_matches_repro(seed):
    from repro.core import query as rqry

    frozen, records, rng = _case(seed)
    frozen.tighten(records, frozen.route(records))
    queries = tuple(random_query(frozen.schema, rng) for _ in range(5))
    port = carry_tree(frozen)
    ref = JaxEngine(frozen, backend="jax")
    eng = LayoutEngine(port, device="cpu")
    for q in queries:
        want = ref.route_query(q)
        np.testing.assert_array_equal(eng.route_query(_port_query(q)), want)
        np.testing.assert_array_equal(
            eng.route_query(_port_query(q), backend="numpy"), want
        )
        np.testing.assert_array_equal(
            tqry.route_query(port, _port_query(q), device="cpu"),
            rqry.route_query(frozen, q),
        )


def test_workload_operands_live_in_the_plan_cache():
    from repro.core import query as rqry

    frozen, records, rng = _case(6)
    port = carry_tree(frozen)
    eng = LayoutEngine(port, device="cpu")
    cap = get_backend("torch").WORKLOAD_PLANS

    def workload():
        queries = tuple(random_query(frozen.schema, rng) for _ in range(3))
        return rqry.Workload(frozen.schema, queries).tensorize(frozen.cuts)

    rwt = workload()
    eng.query_hits(carry_wt(rwt))
    before = build_counts()
    # an equal workload, tensorized again, shares its device operands
    eng.query_hits(carry_wt(rwt))
    assert build_counts() == before
    for _ in range(cap + 3):
        eng.query_hits(carry_wt(workload()))
    assert build_counts()["workload:torch"] == (
        before["workload:torch"] + cap + 3
    )
    # the query plan and the newest ``cap`` workloads stay
    assert len(eng.plans) == 1 + cap


def test_from_arrays_round_trip_and_key_check(tmp_path):
    frozen, records, _ = _case(2)
    arrays = _arrays(frozen)
    port = TorchTree.from_arrays(arrays)
    path = str(tmp_path / "t.npz")
    port.save(path)
    again = TorchTree.load(path)
    for k, v in port.to_arrays().items():
        np.testing.assert_array_equal(v, arrays[k], k)
        np.testing.assert_array_equal(again.to_arrays()[k], v, k)
    np.testing.assert_array_equal(again.route(records), frozen.route(records))
    with pytest.raises(ValueError):
        TorchTree.from_arrays({**arrays, "extra": np.zeros(1)})


def test_zero_plan_builds_once_warm():
    frozen, records, _ = _case(4)
    eng = LayoutEngine(carry_tree(frozen), device="cpu")
    eng.route(records[:10])
    before = build_counts()
    for m in (1, 37, 300, 900):
        eng.route(records[:m])
        eng.fused_step(records[:m], return_bids=False)
    assert build_counts() == before
    assert eng.stats()["plan_cache"]["misses"] == 1


def test_data_generators_match_repro(tpch_small):
    schema, records, work, cuts = tpch_small
    tschema, trecords = tdatagen.make_tpch_like(8_000, seed=0)
    np.testing.assert_array_equal(trecords, records)
    twork, _ = twl.make_tpch_workload(tschema, n_per_template=2, seed=0)
    tcuts = twork.candidate_cuts(max_adv=4)
    for f in ("kind", "dim", "cutpoint", "in_mask", "adv_id"):
        np.testing.assert_array_equal(getattr(tcuts, f), getattr(cuts, f))
    wt, twt = work.tensorize(cuts), twork.tensorize(tcuts)
    for f in ("q_lo", "q_hi", "q_cat", "q_adv", "conj_query"):
        np.testing.assert_array_equal(getattr(twt, f), getattr(wt, f))


def test_greedy_builds_array_equal_trees(tpch_small):
    schema, records, work, cuts = tpch_small
    ref = rgreedy.build_greedy(
        records, work, cuts, rgreedy.GreedyConfig(min_block=250)
    ).freeze()
    tschema, trecords = tdatagen.make_tpch_like(8_000, seed=0)
    twork, _ = twl.make_tpch_workload(tschema, n_per_template=2, seed=0)
    port = tgreedy.build_greedy(
        trecords, twork, twork.candidate_cuts(max_adv=4),
        tgreedy.GreedyConfig(min_block=250),
    ).freeze()
    want = _arrays(ref)
    for k, v in port.to_arrays().items():
        np.testing.assert_array_equal(v, want[k], k)
    stats = trewards.evaluate_layout(port, trecords, twork, device="cpu")
    assert 0 < stats.scanned_fraction < 1


def test_greedy_builds_array_equal_trees_on_a_larger_tpch_sample():
    """The chip run's configuration, scaled down: a 1-in-20 sample of
    400,000 TPC-H-like rows (20,000 rows, 2.5x the fixture), the
    150-query workload and its default candidate cuts."""
    from repro.data import datagen as rdatagen
    from repro.data import workload as rwl

    schema, records = rdatagen.make_tpch_like(400_000, seed=0)
    work, _ = rwl.make_tpch_workload(schema, n_per_template=10, seed=0)
    ref = rgreedy.build_greedy(
        records[::20], work, work.candidate_cuts(),
        rgreedy.GreedyConfig(min_block=200),
    ).freeze()
    tschema, trecords = tdatagen.make_tpch_like(400_000, seed=0)
    np.testing.assert_array_equal(trecords, records)
    twork, _ = twl.make_tpch_workload(tschema, n_per_template=10, seed=0)
    port = tgreedy.build_greedy(
        trecords[::20], twork, twork.candidate_cuts(),
        tgreedy.GreedyConfig(min_block=200),
    ).freeze()
    want = _arrays(ref)
    for k, v in port.to_arrays().items():
        np.testing.assert_array_equal(v, want[k], k)
