"""The port's baseline layouts against the JAX package's, on the CPU.

``random_layout``, ``range_layout`` and ``build_bottom_up`` are host numpy
in both packages; on the same records, workload and cut table the port's
trees equal ``repro``'s by every key ``save`` writes, and their block ids
too.  Their Eq. 1 through the port's torch backend (the query kernel's
plain version) equals the numpy backend's.  ``repro`` is only the oracle.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.baselines import bottom_up as rbu  # noqa: E402
from repro.baselines import partitioners as rpart  # noqa: E402
from repro_torch.baselines import bottom_up as tbu  # noqa: E402
from repro_torch.baselines import partitioners as tpart  # noqa: E402
from repro_torch.core.qdtree import FrozenQdTree as TorchTree  # noqa: E402
from repro_torch.data import datagen as tdatagen  # noqa: E402
from repro_torch.data import workload as twl  # noqa: E402
from repro_torch.engine import LayoutEngine  # noqa: E402
from tests.test_torch_engine import _arrays  # noqa: E402


@pytest.fixture(scope="module")
def tpch():
    """The same table, workload and cuts in both packages (the port's
    generators are array-equal to ``repro``'s)."""
    from repro.data import datagen as rdatagen
    from repro.data import workload as rwl

    rschema, rrec = rdatagen.make_tpch_like(6_000, seed=0)
    rwork, _ = rwl.make_tpch_workload(rschema, n_per_template=2, seed=0)
    tschema, trec = tdatagen.make_tpch_like(6_000, seed=0)
    twork, _ = twl.make_tpch_workload(tschema, n_per_template=2, seed=0)
    np.testing.assert_array_equal(rrec, trec)
    return ((rrec, rschema, rwork, rwork.candidate_cuts(max_adv=4)),
            (trec, tschema, twork, twork.candidate_cuts(max_adv=4)))


def _assert_layouts_equal(port, ref):
    (ptree, pbids), (rtree, rbids) = port, ref
    want = _arrays(rtree)
    got = ptree.to_arrays()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], key)
    np.testing.assert_array_equal(pbids, rbids)
    np.testing.assert_array_equal(
        ptree.block_sizes, np.bincount(rbids, minlength=rtree.n_leaves))


@pytest.mark.parametrize("block_size", [97, 400])
def test_partitioners_match_repro(tpch, block_size):
    (rrec, rschema, _, rcuts), (trec, tschema, _, tcuts) = tpch
    _assert_layouts_equal(
        tpart.random_layout(trec, tschema, tcuts, block_size, seed=3),
        rpart.random_layout(rrec, rschema, rcuts, block_size, seed=3))
    for column in (0, 5):
        _assert_layouts_equal(
            tpart.range_layout(trec, tschema, tcuts, block_size, column),
            rpart.range_layout(rrec, rschema, rcuts, block_size, column))


# (selectivity ceiling, features): BU and BU+ (the paper's Sec 7.5
# tuning), with few enough features that the greedy merge stays quick
@pytest.mark.parametrize("ceiling,features", [(None, 15), (0.5, 6)])
def test_bottom_up_matches_repro(tpch, ceiling, features):
    (rrec, _, rwork, rcuts), (trec, _, twork, tcuts) = tpch
    got = tbu.build_bottom_up(trec, twork, tcuts, tbu.BottomUpConfig(
        block_size=300, max_features=features, selectivity_ceiling=ceiling))
    want = rbu.build_bottom_up(rrec, rwork, rcuts, rbu.BottomUpConfig(
        block_size=300, max_features=features, selectivity_ceiling=ceiling))
    _assert_layouts_equal(got, want)


def test_baseline_eq1_on_torch_equals_numpy(tpch):
    _, (trec, tschema, twork, tcuts) = tpch
    for tree, bids in (
        tpart.range_layout(trec, tschema, tcuts, 250, 0),
        tbu.build_bottom_up(trec, twork, tcuts,
                            tbu.BottomUpConfig(block_size=250)),
    ):
        tree = TorchTree.from_arrays(tree.to_arrays())
        tree.block_sizes = np.bincount(bids, minlength=tree.n_leaves)
        eng = LayoutEngine(tree, device="cpu")
        wt = twork.tensorize(tcuts)
        got = eng._backend("torch").query_intersect(tree, eng.plans, wt,
                                                    eng.device)
        want = eng._backend("numpy").query_intersect(tree, eng.plans, wt,
                                                     eng.device)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
