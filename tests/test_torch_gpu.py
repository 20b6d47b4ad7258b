"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

The kernels have no CPU mode, so every test here is marked ``gpu`` and
skips without a CUDA device.  The file imports neither JAX nor ``repro``
and needs no fixture, so a machine with PyTorch for CUDA and no JAX runs
it alone:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_gpu.py

Trees are random, with range, IN and advanced cuts (every advanced op),
grown from a numpy seed; batch sizes are ragged.  Every comparison is
exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import predicates as preds  # noqa: E402
from repro_torch.core import query as qry  # noqa: E402
from repro_torch.core.qdtree import singleton_tree  # noqa: E402
from repro_torch.engine import LayoutEngine  # noqa: E402
from repro_torch.engine import plan as tplan  # noqa: E402
from repro_torch.kernels import fused_ingest as tfk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import query_intersect as tqk  # noqa: E402
from repro_torch.kernels import route_records as trk  # noqa: E402
from repro_torch.kernels.ref import fused_ingest_ref  # noqa: E402

SEEDS = [0, 1, 7]
pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def random_case(seed, m=3000, splits=40):
    """A random tree over every cut kind, its records and a workload."""
    rng = np.random.default_rng(seed)
    schema = preds.Schema((
        preds.Column("x", "numeric", 5000),
        preds.Column("y", "numeric", 64),
        preds.Column("c", "categorical", 6),
        preds.Column("z", "numeric", 5000),
        preds.Column("k", "categorical", 40),
    ))
    records = np.stack([
        rng.integers(0, 5000, m), rng.integers(0, 64, m),
        rng.integers(0, 6, m), rng.integers(0, 5000, m),
        rng.integers(0, 40, m),
    ], axis=1).astype(np.int32)
    b = preds.CutTableBuilder(schema)
    for c in rng.integers(1, 5000, 12):
        b.add_range(0, preds.OP_LT, int(c))
        b.add_range(3, preds.OP_LT, int(c))
    for c in (8, 16, 32, 48):
        b.add_range(1, preds.OP_LT, c)
    for _ in range(4):
        b.add_in(2, rng.choice(6, 2, replace=False).tolist())
        b.add_in(4, rng.choice(40, 9, replace=False).tolist())
    for op in range(6):
        b.add_adv(0, op, 3)
    cuts = b.build()
    tree = singleton_tree(schema, cuts, np.arange(m))
    M = preds.eval_cuts(records, cuts)
    leaves = [tree.root]
    for _ in range(splits):
        node = leaves[int(rng.integers(0, len(leaves)))]
        legal = [c for c in range(cuts.n_cuts)
                 if 0 < M[node.rows, c].sum() < node.size]
        if not legal:
            continue
        leaves = [n for n in leaves if n is not node]
        leaves += list(tree.split(
            node, int(rng.choice(legal)), cut_matrix=M
        ))
    atoms = [
        qry.RangeAtom(0, preds.OP_LT, 2500), qry.RangeAtom(3, preds.OP_GE, 900),
        qry.InAtom(2, (1, 4)), qry.InAtom(4, (3, 5, 30)),
        qry.AdvAtom(0, preds.OP_LT, 3, polarity=True),
        qry.AdvAtom(0, preds.OP_EQ, 3, polarity=False),
    ]
    queries = tuple(
        qry.Query.disjunction([
            [atoms[i] for i in rng.choice(len(atoms), 2, replace=False)]
            for _ in range(int(rng.integers(1, 3)))
        ])
        for _ in range(12)
    )
    return tree.freeze(), records, qry.Workload(schema, queries)


@pytest.mark.parametrize("seed", SEEDS)
def test_route_kernels_match_plain(seed):
    dev = _cuda()
    frozen, records, _ = random_case(seed)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records[: 2000 + seed]).to(dev)
    m_k = trk.eval_cuts(rec, ops)
    torch.cuda.synchronize()
    assert torch.equal(m_k, trk.eval_cuts_plain(rec, ops))
    bids = trk.locate_leaf(m_k, ops)
    assert torch.equal(bids, trk.locate_leaf_plain(m_k, ops))
    np.testing.assert_array_equal(
        bids.cpu().numpy(), frozen.route(records[: 2000 + seed])
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_ingest_kernel_matches_plain(seed):
    dev = _cuda()
    frozen, records, _ = random_case(seed)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    got = tfk.fused_ingest(rec, ops)
    torch.cuda.synchronize()
    for name, a, b in zip(got._fields, got, tfk.fused_ingest_plain(rec, ops)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("seed", SEEDS)
def test_query_intersect_kernel_matches_plain(seed):
    dev = _cuda()
    frozen, records, work = random_case(seed)
    frozen.tighten(records, frozen.route(records))
    wt = work.tensorize(frozen.cuts)
    n_adv = frozen.cuts.n_adv
    args = (
        tplan.to_device(tplan.pack_leaf_descs(frozen), dev),
        tplan.to_device(tops.pack_workload(wt, n_adv), dev),
        tplan.to_device(tops.query_layout(frozen.schema, n_adv), dev),
    )
    got = tqk.query_intersect(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, tqk.query_intersect_plain(*args)):
        assert torch.equal(a, b)
    conj = qry.conjuncts_intersect(
        frozen.leaf_lo, frozen.leaf_hi, frozen.leaf_cat, frozen.leaf_adv,
        wt, frozen.schema,
    )
    np.testing.assert_array_equal(got[0].cpu().numpy().astype(bool), conj)


@pytest.mark.parametrize("seed", SEEDS)
def test_engine_on_card_matches_numpy_oracle(seed):
    dev = _cuda()
    frozen, records, work = random_case(seed)
    eng = LayoutEngine(frozen)  # device None: the GPU
    assert eng.device == dev
    want_bids, want = fused_ingest_ref(frozen, records)
    np.testing.assert_array_equal(eng.route(records), want_bids)
    bids, part = eng.fused_step(torch.from_numpy(records).to(dev))
    np.testing.assert_array_equal(bids, want_bids)
    for f in ("counts", "lo", "hi", "cat", "adv"):
        np.testing.assert_array_equal(getattr(part, f), getattr(want, f))
    stats = eng.skip_stats(records, work)
    oracle = LayoutEngine(frozen, backend="numpy", device="cpu")
    np.testing.assert_array_equal(
        stats.query_hits, oracle.query_hits(work)
    )
    np.testing.assert_array_equal(
        stats.conj_scanned,
        oracle.skip_stats(records, work, tighten=False).conj_scanned,
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_route_query_launches_on_card(seed):
    from repro_torch.kernels import _build

    _cuda()
    frozen, records, work = random_case(seed)
    frozen.tighten(records, frozen.route(records))
    eng = LayoutEngine(frozen)
    oracle = LayoutEngine(frozen, backend="numpy", device="cpu")
    for q in work.queries:
        before = _build.launch_counts()["query_intersect"]
        got = eng.route_query(q)
        assert _build.launch_counts()["query_intersect"] == before + 1
        np.testing.assert_array_equal(got, oracle.route_query(q))


def test_wrappers_refuse_mismatched_operands():
    dev = _cuda()
    frozen, records, _ = random_case(0)
    host_ops = tplan.to_device(tplan.pack_route_constants(frozen), "cpu")
    rec = torch.from_numpy(records).to(dev)
    with pytest.raises(ValueError, match="not cuda"):
        tfk.fused_ingest(rec, host_ops)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    with pytest.raises(ValueError, match="columns"):
        trk.eval_cuts(rec[:, :3].contiguous(), ops)
    with pytest.raises(ValueError, match="int32"):
        trk.eval_cuts(rec.to(torch.int64), ops)
