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

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core import predicates as preds  # noqa: E402
from repro_torch.core import query as qry  # noqa: E402
from repro_torch.core.qdtree import random_layout, singleton_tree  # noqa: E402
from repro_torch.engine import LayoutEngine  # noqa: E402
from repro_torch.engine import plan as tplan  # noqa: E402
from repro_torch.kernels import fused_ingest as tfk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import query_intersect as tqk  # noqa: E402
from repro_torch.kernels import route_records as trk  # noqa: E402
from repro_torch.kernels.ref import fused_ingest_ref  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import common as lm_common  # noqa: E402
from repro_torch.models import model as lm_model  # noqa: E402

SEEDS = [0, 1, 7]
pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


SCHEMA = preds.Schema((
    preds.Column("x", "numeric", 5000),
    preds.Column("y", "numeric", 64),
    preds.Column("c", "categorical", 6),
    preds.Column("z", "numeric", 5000),
    preds.Column("k", "categorical", 40),
))


def case_records(rng, m):
    return np.stack([
        rng.integers(0, 5000, m), rng.integers(0, 64, m),
        rng.integers(0, 6, m), rng.integers(0, 5000, m),
        rng.integers(0, 40, m),
    ], axis=1).astype(np.int32)


def grow_tree(cuts, records, rng, splits, chain=False):
    """A tree over ``cuts`` grown by ``splits`` random legal splits of
    random leaves; with ``chain``, of the larger child of the last split,
    which makes the tree as deep as the records allow."""
    tree = singleton_tree(cuts.schema, cuts, np.arange(records.shape[0]))
    M = preds.eval_cuts(records, cuts)
    leaves = [tree.root]
    for _ in range(splits):
        if chain:
            node = max(leaves[-2:], key=lambda n: n.size)
        else:
            node = leaves[int(rng.integers(0, len(leaves)))]
        legal = [c for c in range(cuts.n_cuts)
                 if 0 < M[node.rows, c].sum() < node.size]
        if not legal:
            continue
        leaves = [n for n in leaves if n is not node]
        leaves += list(tree.split(
            node, int(rng.choice(legal)), cut_matrix=M
        ))
    return tree.freeze()


def random_case(seed, m=3000, splits=40):
    """A random tree over every cut kind, its records and a workload."""
    rng = np.random.default_rng(seed)
    schema = SCHEMA
    records = case_records(rng, m)
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
    frozen = grow_tree(cuts, records, rng, splits)
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
    return frozen, records, qry.Workload(schema, queries)


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


ROUTE_SIZES = [0, 1, 31, 33, 2**16 + 5]


# route_descend's forced kernels: (variant, warps, staged nodes)
ROUTE_FORCED = [(None, None, None), ("global", None, None),
                ("prefix", None, None), ("prefix", 4, 3)]


@pytest.mark.parametrize("forced", ROUTE_FORCED,
                         ids=["plan", "global", "prefix", "prefix_w4_k3"])
@pytest.mark.parametrize("m", ROUTE_SIZES)
def test_route_descend_matches_plain(m, forced):
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records, _ = random_case(m % 7)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    # the tree's records, repeated, past m + 1 rows
    host = np.resize(records, (m + 1, records.shape[1]))
    full = torch.from_numpy(host).to(dev)
    with trk._forced(*forced):
        plan = trk.route_plan(ops)
    assert plan.kernel == trk.VARIANTS[forced[0] or "shared"]
    if forced[2]:
        assert (plan.warps, plan.prefix) == forced[1:]
    ops["route_plan"] = plan
    name = trk.ROUTE_KERNELS[plan.kernel]
    # a batch at the allocation's start, and one 4 bytes into a row
    for rec, want_host in ((full[:m], host[:m]), (full[1:], host[1:])):
        assert rec.shape[0] == m
        before = _build.launch_counts()
        got = trk.route(rec, ops)
        after = _build.launch_counts()
        assert after["route_descend"] == before["route_descend"] + (m > 0)
        assert after[name] == before[name] + (m > 0)
        torch.cuda.synchronize()
        assert torch.equal(got, trk.route_plain(rec, ops))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      frozen.route(want_host))


@pytest.mark.parametrize("prefix", [1, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_prefix_kernel_tests_every_cut_kind_past_the_prefix(seed, prefix):
    """The prefix kernel with only the root (or three nodes) staged, so
    that range, IN and advanced cuts are read through L2: equal to the
    plain version and the numpy route on a ragged batch, aligned and 4
    bytes into a row (16-byte copies and 4-byte ones)."""
    dev = _cuda()
    frozen, records, _ = random_case(seed, m=4001, splits=80)
    internal = np.flatnonzero(frozen.cut_id >= 0)
    past = internal[internal >= prefix]
    assert set(frozen.cuts.kind[frozen.cut_id[past]].tolist()) == {0, 1, 2}
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    with trk._forced("prefix", None, prefix):
        ops["route_plan"] = trk.route_plan(ops)
    assert ops["route_plan"].prefix == prefix
    full = torch.from_numpy(records).to(dev)
    for rec, want_host in ((full[:3999], records[:3999]),
                           (full[1:], records[1:])):
        got = trk.route(rec, ops)
        torch.cuda.synchronize()
        assert torch.equal(got, trk.route_plain(rec, ops))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      frozen.route(want_host))


def test_route_descend_plan_by_shape():
    dev = _cuda()
    props = torch.cuda.get_device_properties(dev)
    optin = props.shared_memory_per_block_optin
    assert trk.optin_bytes(dev.index) == optin

    def _plan(n_nodes, d, forced=(None,)):
        with trk._forced(*forced):
            return trk.route_plan({
                "nodes": torch.zeros((n_nodes, 4), dtype=torch.int32,
                                     device=dev),
                "cat_off": torch.zeros(d, dtype=torch.int32, device=dev)})

    # tpch-40M's 1,447 nodes at 21 columns: the nodes and 32 warps' tiles,
    # two blocks an SM, as the arithmetic says
    plan = _plan(1447, 21)
    assert plan._replace(most=0) == trk.descend_plan(1447, 21, optin)
    assert (plan.kernel, plan.warps, plan.smem) == (1, 32,
                                                    16 * 1447 + 32 * 2688)
    assert plan.most == 2 * props.multi_processor_count
    # past the shared kernel's reach: the prefix kernel, at least two
    # blocks of 21 warps an SM (its registers allow two); forced to fill a
    # block, one
    for n_nodes, forced, per_sm in ((15_999, (None,), 2), (39_999, (None,), 2),
                                    (39_999, ("prefix", 32), 1)):
        plan = _plan(n_nodes, 21, forced)
        assert plan._replace(most=0) == trk.descend_plan(n_nodes, 21, optin,
                                                         *forced)
        assert plan.kernel == 3
        assert plan.most >= per_sm * props.multi_processor_count
    # forcing the shared kernel past the card's limit raises
    with pytest.raises(RuntimeError, match="route_descend kernel launch"):
        _plan(optin // 16, 21, ("shared",))


def cut_table(seed, n_cuts):
    """``n_cuts`` cuts over ``SCHEMA`` in shuffled order, so that the kinds
    interleave.  From 8 cuts up: every advanced op, the IN set {0} of the
    first categorical column (bit 0) and {39} of the last (bit bits - 1),
    the two ends of the plain version's clip."""
    rng = np.random.default_rng(seed)
    b = preds.CutTableBuilder(SCHEMA)
    for op in range(6):
        b.add_adv(0, op, 3)
    b.add_in(2, [0])
    b.add_in(4, [39])
    for c in rng.choice(np.arange(1, 5000), 200, replace=False):
        b.add_range(0, preds.OP_LT, int(c))
        b.add_range(3, preds.OP_LT, int(c))
    for c in range(1, 64, 4):
        b.add_range(1, preds.OP_LT, c)
    for _ in range(120):
        b.add_in(4, rng.choice(40, 7, replace=False).tolist())
        b.add_in(2, rng.choice(6, 3, replace=False).tolist())
    full = b.build()
    one = full.in_mask.sum(axis=1) == 1
    ends = (full.in_mask[:, 0] | full.in_mask[:, -1]) & one
    special = np.flatnonzero((full.kind == preds.KIND_ADV) | ends)
    assert special.shape[0] == 8
    rest = np.setdiff1d(np.arange(full.n_cuts), special)
    if n_cuts < special.shape[0]:
        pick = rng.choice(special, n_cuts, replace=False)
    else:
        pick = np.concatenate([special, rng.choice(
            rest, n_cuts - special.shape[0], replace=False)])
    pick = rng.permutation(pick)
    return preds.CutTable(
        schema=SCHEMA, kind=full.kind[pick], dim=full.dim[pick],
        cutpoint=full.cutpoint[pick], in_mask=full.in_mask[pick],
        adv_id=full.adv_id[pick], adv=full.adv,
    )


def edge_records(seed, m):
    """``m`` records in the domains; in every fourth row the first
    categorical column at 0, in another the last at 39 (its bit is bits -
    1), in a third z == x (so that every advanced op splits them)."""
    rng = np.random.default_rng(seed)
    rec = case_records(rng, m)
    rec[::4, 2] = 0
    rec[1::4, 4] = 39
    rec[2::4, 3] = rec[2::4, 0]
    return rec


def _variant_kernel(variant):
    return 2 if variant == "global" else 1


EVAL_SIZES = [0, 1, 31, 33, 2**16 + 5]
N_CUTS = [1, 17, 379]


@pytest.mark.parametrize("variant", ["shared", "global"])
@pytest.mark.parametrize("n_cuts", N_CUTS)
@pytest.mark.parametrize("m", EVAL_SIZES)
def test_eval_cuts_matches_plain(m, n_cuts, variant):
    """Each eval_cuts kernel equals its plain version and preds.eval_cuts:
    at the allocation's start and at a row view 20 bytes in (not 16-byte
    aligned), over every cut kind in shuffled order."""
    from repro_torch.kernels import _build

    dev = _cuda()
    cuts = cut_table(n_cuts + m % 7, n_cuts)
    host = edge_records(m, m + 1)
    ops = tplan.to_device(tplan.pack_cut_table(cuts), dev)
    full = torch.from_numpy(host).to(dev)
    with trk._forced(variant):
        assert trk.eval_cuts_plan(ops)[0] == _variant_kernel(variant)
        for rec, want_host in ((full[:m], host[:m]), (full[1:], host[1:])):
            assert rec.shape[0] == m
            before = _build.launch_counts()["eval_cuts"]
            got = trk.eval_cuts(rec, ops)
            assert _build.launch_counts()["eval_cuts"] == before + (m > 0)
            torch.cuda.synchronize()
            assert torch.equal(got, trk.eval_cuts_plain(rec, ops))
            np.testing.assert_array_equal(got.cpu().numpy().astype(bool),
                                          preds.eval_cuts(want_host, cuts))


@pytest.mark.parametrize("variant", ["shared", "global"])
def test_eval_cuts_clips_out_of_domain_codes_like_plain(variant):
    """Codes below a categorical column's domain and past it clip, in both
    kernels, to bit 0 and bit bits - 1 as the plain version clips them."""
    dev = _cuda()
    cuts = cut_table(5, 379)
    host = edge_records(5, 4099)
    host[::3, 2] = -3
    host[1::3, 4] = 45
    host[2::5, 2] = 9  # past c's domain: into k's bits
    ops = tplan.to_device(tplan.pack_cut_table(cuts), dev)
    rec = torch.from_numpy(host).to(dev)
    with trk._forced(variant):
        got = trk.eval_cuts(rec, ops)
    torch.cuda.synchronize()
    assert torch.equal(got, trk.eval_cuts_plain(rec, ops))


def _locate_case(n_cuts, m, splits, seed, chain=False):
    cuts = cut_table(seed, n_cuts)
    records = edge_records(seed, 3000)
    frozen = grow_tree(cuts, records, np.random.default_rng(seed), splits,
                       chain)
    return frozen, np.resize(records, (m + 1, records.shape[1]))


def _assert_locate(frozen, host, m, variant):
    """locate_leaf (``variant`` forced) on the kernel's predicate matrix of
    ``host[:m]`` and of the view ``host[1:]`` (``n_cuts`` bytes in): equal
    to the plain version, the numpy route and route_descend."""
    from repro_torch.kernels import _build

    dev = _cuda()
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    full = torch.from_numpy(host).to(dev)
    m_full = trk.eval_cuts(full, ops)
    with trk._forced(variant):
        assert trk.locate_leaf_plan(ops)[0] == _variant_kernel(variant)
        for rows, want_host in ((slice(0, m), host[:m]),
                                (slice(1, m + 1), host[1:])):
            mm = m_full[rows]
            before = _build.launch_counts()["locate_leaf"]
            got = trk.locate_leaf(mm, ops)
            assert _build.launch_counts()["locate_leaf"] == before + (m > 0)
            torch.cuda.synchronize()
            assert torch.equal(got, trk.locate_leaf_plain(mm, ops))
            assert torch.equal(got, trk.route(full[rows], ops))
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          frozen.route(want_host))


@pytest.mark.parametrize("variant", ["shared", "global"])
@pytest.mark.parametrize("n_cuts", N_CUTS)
@pytest.mark.parametrize("m", EVAL_SIZES)
def test_locate_leaf_matches_plain(m, n_cuts, variant):
    """Each locate_leaf kernel over trees on 1, 17 and 379 cuts (one cut: a
    tree of depth 1)."""
    frozen, host = _locate_case(n_cuts, m, 60, n_cuts + m % 7)
    if n_cuts == 1:
        assert frozen.depth == 1
    _assert_locate(frozen, host, m, variant)


@pytest.mark.parametrize("variant", ["shared", "global"])
def test_locate_leaf_on_a_deep_tree(variant):
    """The deepest random tree: a chain of random splits over 379 cuts,
    deeper than tpch-40M's greedy tree (19)."""
    frozen, host = _locate_case(379, 40_000, 60, 11, chain=True)
    assert frozen.depth > 19
    _assert_locate(frozen, host, 40_000, variant)


def test_eval_cuts_and_locate_leaf_plans_by_shape():
    from repro_torch.kernels import _build

    dev = _cuda()
    props = torch.cuda.get_device_properties(dev)
    optin = props.shared_memory_per_block_optin
    # tpch-40M: 379 cuts at 21 columns, 1,447 nodes
    kernel, warps, smem, most = _build.plan("eval_cuts", dev.index, 379, 21,
                                            146, 0)
    # the table (8 B a cut), the IN flags (5 words a cut: 146 bits, 32 to
    # a word, the count made odd), then a warp's tile of 16 records as
    # staged and transposed (a column's 16 values 20 words apart) and its
    # output tile
    per_warp = 64 * 21 + 80 * 21 + 16 * 379
    assert (kernel, smem) == (1, 3040 + 7584 + warps * per_warp)
    assert most >= props.multi_processor_count
    kernel, warps, smem, most = _build.plan("locate_leaf", dev.index, 1447,
                                            379, 0)
    # the nodes, then two barriers (8 B) and two tiles of 16 rows a warp
    assert (kernel, smem) == (1, 16 * 1447 + 16 + warps * 2 * (16 * 379 + 8))
    assert most >= props.multi_processor_count
    # past four warps' tiles: the global kernel; forcing the shared one
    # past the card's limit raises
    too_many = optin // 64 + 1  # eval_cuts cuts
    assert _build.plan("eval_cuts", dev.index, too_many, 21, 146, 0)[0] == 2
    with pytest.raises(RuntimeError, match="eval_cuts kernel launch"):
        _build.plan("eval_cuts", dev.index, optin // 32 + 1, 21, 146, 1)
    too_many = (optin - 4 * 2 * (16 * 379 + 8)) // 16  # locate_leaf nodes
    assert _build.plan("locate_leaf", dev.index, too_many, 379, 0)[0] == 2
    with pytest.raises(RuntimeError, match="locate_leaf kernel launch"):
        _build.plan("locate_leaf", dev.index, optin // 16, 379, 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_engine_route_is_one_route_descend_launch(seed):
    from repro_torch.kernels import _build

    _cuda()
    frozen, records, _ = random_case(seed)
    eng = LayoutEngine(frozen)
    eng.route(records[:5])  # the tree plan, with the route plan in it
    before = _build.launch_counts()
    got = eng.route(records)
    after = _build.launch_counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert delta == {"route_descend": 1, "route_descend_shared": 1}
    np.testing.assert_array_equal(got, frozen.route(records))


@pytest.mark.parametrize("n_leaves", [8000, 20_000])
def test_engine_route_past_the_shared_kernel_is_one_planned_launch(n_leaves):
    """``LayoutEngine.route`` on a tree whose nodes do not fit beside four
    warps' tiles: one launch of the planned kernel and nothing else, equal
    to the numpy route; and each kernel forced equal to it too."""
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records = tpch_case(n_leaves, 5000)
    optin = trk.optin_bytes(dev.index)
    assert trk.shared_fit(frozen.n_nodes, 21, optin) < trk.MIN_WARPS
    name = trk.ROUTE_KERNELS[trk.descend_plan(frozen.n_nodes, 21,
                                              optin).kernel]
    eng = LayoutEngine(frozen)
    eng.route(records[:5])  # the tree plan, with the route plan in it
    before = _build.launch_counts()
    got = eng.route(records)
    after = _build.launch_counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert delta == {"route_descend": 1, name: 1}
    want = frozen.route(records)
    np.testing.assert_array_equal(got, want)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    for variant in ("prefix", "global"):
        with trk._forced(variant):
            plan = trk.route_plan(ops)
        got = trk.route(rec, {**ops, "route_plan": plan})
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def wide_case(seed, d=160, m=4000, leaves=200):
    """A tree whose aggregates exceed a block's shared memory: 160
    columns, 200 leaves (259 KB of aggregates)."""
    rng = np.random.default_rng(seed)
    cols = [preds.Column(f"x{j}", "numeric", 1000) for j in range(d - 1)]
    schema = preds.Schema((*cols, preds.Column("c", "categorical", 37)))
    records = np.concatenate([
        rng.integers(0, 1000, (m, d - 1)), rng.integers(0, 37, (m, 1)),
    ], axis=1).astype(np.int32)
    b = preds.CutTableBuilder(schema)
    for j in range(4):
        for c in range(25, 1000, 25):
            b.add_range(j, preds.OP_LT, c)
    b.add_in(d - 1, list(range(0, 37, 3)))
    b.add_adv(0, preds.OP_LT, 1)
    cuts = b.build()
    tree = singleton_tree(schema, cuts, np.arange(m))
    M = preds.eval_cuts(records, cuts)
    open_leaves = [tree.root]
    while len(open_leaves) < leaves:
        for node in sorted(open_leaves, key=lambda n: -n.size):
            legal = [c for c in range(cuts.n_cuts)
                     if 0 < M[node.rows, c].sum() < node.size]
            if legal:
                break
        open_leaves = [n for n in open_leaves if n is not node]
        open_leaves += list(tree.split(node, int(rng.choice(legal)),
                                       cut_matrix=M))
    return tree.freeze(), records


def _fold_both(ops, batches, variant, *split):
    """Fold the same batches with the kernel (``variant`` forced, the
    cluster kernel's ``split`` (blocks a cluster, ranges) too) and with the
    plain version; the block ids of each, and the two accumulators."""
    with tfk._forced(variant, *split):
        acc_k = tfk.IngestAccumulator(ops)
    acc_p = tfk.IngestAccumulator(ops)
    got = [acc_k.fold(b, bids=True) for b in batches]
    want = [tfk.fused_ingest_plain(b, acc_p) for b in batches]
    torch.cuda.synchronize()
    return torch.cat(got), torch.cat(want), acc_k, acc_p


def _assert_same(acc_k, acc_p):
    for name, a, b in zip(acc_k.FIELDS, acc_k.tensors(), acc_p.tensors()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_ingest_kernel_matches_plain(seed):
    dev = _cuda()
    frozen, records, _ = random_case(seed)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    got, want, acc_k, acc_p = _fold_both(ops, [rec], None)
    assert torch.equal(got, want)
    _assert_same(acc_k, acc_p)


@pytest.mark.parametrize("variant", ["shared", "cluster", "leafwise",
                                     "global"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fused_variants_match_plain(seed, variant):
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records, _ = random_case(seed)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    # an unaligned batch (rows 1..) takes the 4-byte copies
    for rec in (torch.from_numpy(records).to(dev),
                torch.from_numpy(records).to(dev)[1:]):
        names = tfk.KERNEL_NAMES[tfk.VARIANTS[variant]]
        before = _build.launch_counts()
        got, want, acc_k, acc_p = _fold_both(ops, [rec], variant)
        after = _build.launch_counts()
        assert {k: after[k] - before[k] for k in _build.LAUNCH_NAMES} == {
            k: int(k in names) for k in _build.LAUNCH_NAMES}
        assert torch.equal(got, want)
        _assert_same(acc_k, acc_p)


def test_shared_plan_takes_every_warp_that_fits():
    def _plan(index, shape, variant):
        return tfk.device_plan(index, shape, variant)[:4]

    dev = _cuda()
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    # (L, d, cw, aw, categorical columns, adv cuts); the first is tpch-40M's
    for shape in ((724, 21, 5, 1, 11, 3), (40, 5, 2, 1, 2, 6),
                  (900, 21, 5, 1, 11, 3)):
        L, d, cw, aw, n_cat, n_adv = shape
        # the aggregates, the tables and a changed bit a leaf
        fixed = (4 * L * (1 + 2 * d + cw + 2 * aw) + 4 * (n_cat + d + 3 * n_adv)
                 + 4 * -(-L // 32))
        warps = min(32, (optin - fixed) // (4 * 32 * d))
        kernel, got_warps, smem, most = _plan(dev.index, shape, None)
        if warps < 4:
            assert kernel == 4
            continue
        assert (kernel, got_warps, smem) == (1, warps, fixed + warps * 128 * d)
        assert most >= torch.cuda.get_device_properties(dev).multi_processor_count
    if optin >= 232448:  # an H100's 227 KB: every warp fits at tpch-40M
        assert _plan(dev.index, (724, 21, 5, 1, 11, 3), None)[1] == 32


@pytest.mark.parametrize("variant", [None, "shared", "cluster", "leafwise",
                                     "global"])
def test_running_fold_over_uneven_batches(variant):
    dev = _cuda()
    frozen, records, _ = random_case(1)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    bounds = [0, 1, 700, 701, 2048, 2999, records.shape[0]]
    batches = [rec[s:e] for s, e in zip(bounds, bounds[1:])]
    got, want, acc_k, acc_p = _fold_both(ops, batches, variant)
    assert torch.equal(got, want)
    _assert_same(acc_k, acc_p)
    # ... and the stream equals the numpy oracle over the concatenation
    want_bids, want_part = fused_ingest_ref(frozen, records)
    np.testing.assert_array_equal(got.cpu().numpy(), want_bids)
    part = acc_k.partial(frozen)
    for f in ("counts", "lo", "hi", "cat", "adv"):
        np.testing.assert_array_equal(getattr(part, f),
                                      getattr(want_part, f))


def test_tree_too_large_for_shared_memory():
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records = wide_case(0)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    before = _build.launch_counts()
    got, want, acc_k, acc_p = _fold_both(ops, [rec[:1], rec[1:]], None)
    after = _build.launch_counts()
    # the plan's kernel: a cluster of two does not hold 200 leaves of 160
    # columns beside 4 warps' tiles either
    assert {k: after[k] - before[k] for k in after} == {
        k: 2 * (k == "fused_ingest_global") for k in after}
    assert torch.equal(got, want)
    _assert_same(acc_k, acc_p)
    # forcing the shared kernel raises: the request is refused, and
    # nothing falls back to another kernel or the plain version
    with pytest.raises(RuntimeError, match="fused_ingest kernel launch"):
        with tfk._forced("shared"):
            tfk.IngestAccumulator(ops)
    assert _build.launch_counts() == after
    # the refusal leaves no error behind for the next launch
    acc = tfk.IngestAccumulator(ops)
    acc.fold(rec)
    torch.cuda.synchronize()


def tpch_case(n_leaves, m, seed=0):
    """A tree of ``n_leaves`` leaves over the TPC-H-like schema and the
    tpch workload's cuts (tpch-40M's), grown by random legal splits of a
    sample, and ``m`` other records."""
    from repro_torch.data.datagen import make_tpch_like
    from repro_torch.data.workload import make_tpch_workload

    schema, sample = make_tpch_like(4 * n_leaves, seed=seed)
    work, _ = make_tpch_workload(schema, n_per_template=10, seed=seed)
    frozen = random_layout(work.candidate_cuts(), sample, n_leaves, seed)
    assert frozen.n_leaves == n_leaves
    return frozen, make_tpch_like(m, seed=seed + 1)[1]


def _assert_oracle(frozen, records, bids, acc):
    want_bids, want = fused_ingest_ref(frozen, records)
    np.testing.assert_array_equal(bids.cpu().numpy(), want_bids)
    part = acc.partial(frozen)
    for f in ("counts", "lo", "hi", "cat", "adv"):
        np.testing.assert_array_equal(getattr(part, f), getattr(want, f), f)


def _shared_accumulators(ops):
    """An accumulator the plan gives the shared kernel, and one for the
    plain version."""
    acc = tfk.IngestAccumulator(ops)
    assert acc._launch.kernel == tfk.VARIANTS["shared"]
    return acc, tfk.IngestAccumulator(ops)


def _fold_pair(acc, plain, batches):
    for b in batches:
        acc.fold(b)
        tfk.fused_ingest_plain(b, plain)
    torch.cuda.synchronize()
    _assert_same(acc, plain)


def _moving_rows(acc, ops, pool):
    """For each way a row can move a leaf's running aggregates (a new
    minimum, a new maximum, an unseen categorical value, an advanced cut
    newly seen true, newly seen false): the first row of ``pool`` that
    does, by index."""
    from repro_torch.core.routing import adv_truth

    leaf = tfk.route_plain(pool, ops).long()
    lo, hi = acc.lo[leaf], acc.hi[leaf]
    cat_dims = ops["cat_dims"].long()
    pos = (pool[:, cat_dims] + ops["cat_off"][cat_dims]).clamp(
        0, int(ops["bits"]) - 1).long()
    cat = acc.cat[leaf[:, None], pos >> 5]
    unseen_cat = ((cat >> (pos & 31)) & 1) == 0
    n_adv = int(ops["n_adv"])
    truth = adv_truth(pool, ops["adv"])[:, :n_adv]
    a = torch.arange(n_adv, device=pool.device)

    def unseen(words, wanted):
        bit = (words[leaf[:, None], a >> 5] >> (a & 31)) & 1
        return ((bit == 0) & wanted).any(1)

    kinds = {
        "min": (pool < lo).any(1), "max": (pool > hi).any(1),
        "cat": unseen_cat.any(1), "adv_true": unseen(acc.advt, truth),
        "adv_false": unseen(acc.advf, ~truth),
    }
    return {k: int(v.nonzero()[0]) for k, v in kinds.items()}, leaf


def test_shared_fold_of_a_batch_again_moves_only_the_counts():
    """The first fold starts from the identities; a second fold of the
    same batch starts every block from the aggregates the first left: no
    row moves a value, and only the counts change."""
    dev = _cuda()
    frozen, records = tpch_case(724, 2**16 + 5)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    acc, plain = _shared_accumulators(ops)
    assert not acc._seeded
    _fold_pair(acc, plain, [rec])
    assert acc._seeded
    first = [t.clone() for t in acc.tensors()]
    _fold_pair(acc, plain, [rec])
    assert torch.equal(acc.counts, 2 * first[0])
    for name, now, was in zip(acc.FIELDS[1:], acc.tensors()[1:], first[1:]):
        assert torch.equal(now, was), name


def test_shared_fold_merges_each_leaf_a_row_moves():
    """A seeded accumulator, then a batch of rows it has seen with five
    rows spread among them that each move a leaf: a new minimum, a new
    maximum, an unseen categorical value, an advanced cut newly seen true
    and newly seen false.  Each of those leaves is marked and merged: the
    accumulator moves there, and equals the plain version."""
    dev = _cuda()
    frozen, records = tpch_case(724, 60_000)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    seen, pool = rec[:40_000], rec[40_000:]
    acc, plain = _shared_accumulators(ops)
    _fold_pair(acc, plain, [seen])
    picks, leaf = _moving_rows(acc, ops, pool)
    batch = seen.clone()
    at = torch.linspace(0, batch.shape[0] - 1, len(picks)).long()
    batch[at.to(dev)] = pool[torch.tensor(list(picks.values()), device=dev)]
    before = [t.clone() for t in acc.tensors()[1:]]
    _fold_pair(acc, plain, [batch])
    for kind, i in picks.items():
        lf = int(leaf[i])
        assert any(not torch.equal(now[lf], was[lf]) for now, was in
                   zip(acc.tensors()[1:], before)), kind


def test_shared_folds_from_two_streams_into_one_accumulator():
    """Two threads, each on its own stream, fold their halves into one
    accumulator three times: a block's seed read while the other stream
    merges is stale only in the safe direction."""
    import threading

    dev = _cuda()
    frozen, records = tpch_case(724, 200_000)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    acc, plain = _shared_accumulators(ops)
    torch.cuda.synchronize()

    def fold(x):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            for _ in range(3):
                acc.fold(x)
            torch.cuda.current_stream(dev).synchronize()

    threads = [threading.Thread(target=fold, args=(x,))
               for x in rec.chunk(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    for _ in range(3):
        tfk.fused_ingest_plain(rec, plain)
    torch.cuda.synchronize()
    _assert_same(acc, plain)


@pytest.mark.parametrize("n_leaves", [723, 724])
def test_shared_seed_from_an_unaligned_accumulator(n_leaves):
    """At 723 leaves the running lo starts 8 bytes past a 16-byte line
    (after 723 int64 counts), so the seed goes 4 bytes at a time; at 724
    16 bytes at a time.  An unaligned batch (rows 1..) with a ragged tail,
    folded in uneven batches, equals the plain version either way."""
    dev = _cuda()
    frozen, records = tpch_case(n_leaves, 70_000)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)[1:]
    acc, plain = _shared_accumulators(ops)
    assert (acc.lo.data_ptr() % 16 == 0) == (n_leaves == 724)
    bounds = [0, 1, 34, 4135, 40_001, rec.shape[0]]
    _fold_pair(acc, plain, [rec[s:e] for s, e in zip(bounds, bounds[1:])])
    _fold_pair(acc, plain, [rec[33:]])


def test_shared_kernel_near_its_reach():
    """900 leaves at 21 columns, tpch-40M's shape: 19 warps fit beside the
    aggregates and a changed bit a leaf on an H100."""
    dev = _cuda()
    frozen, records = tpch_case(900, 3 * 2**15 + 7)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    shape = tfk.plan_shape(ops)
    assert shape == (900, 21, 5, 1, 11, 3)
    rec = torch.from_numpy(records).to(dev)
    acc, plain = _shared_accumulators(ops)
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    assert acc._launch.warps == tfk.shared_warps_fit(shape, optin)
    _fold_pair(acc, plain, list(rec.split(2**15)))
    _fold_pair(acc, plain, list(rec.split(2**15)))


# the cluster kernel's (blocks a cluster, ranges): each size, and a tree
# split over two and three ranges of one launch
CLUSTER_SPLITS = [(2, 1), (4, 1), (8, 1), (16, 1), (2, 3), (16, 2)]
SPLIT_IDS = [f"c{c}r{r}" for c, r in CLUSTER_SPLITS]


@pytest.mark.parametrize("m", ROUTE_SIZES)
@pytest.mark.parametrize("split", CLUSTER_SPLITS, ids=SPLIT_IDS)
def test_cluster_kernel_matches_plain_and_oracle(split, m):
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records, _ = random_case(m % 7)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    host = np.resize(records, (m + 1, records.shape[1]))
    full = torch.from_numpy(host).to(dev)
    # a batch at the allocation's start, and one 4 bytes into a row
    for rec, want_host in ((full[:m], host[:m]), (full[1:], host[1:])):
        before = _build.launch_counts()
        got, want, acc_k, acc_p = _fold_both(ops, [rec], "cluster", *split)
        after = _build.launch_counts()
        assert (acc_k._launch.cluster, acc_k._launch.ranges) == split
        assert {k: after[k] - before[k] for k in after} == {
            k: int(m > 0 and k == "fused_ingest_cluster") for k in after}
        assert torch.equal(got, want)
        _assert_same(acc_k, acc_p)
        _assert_oracle(frozen, want_host, got, acc_k)


@pytest.mark.parametrize("split", CLUSTER_SPLITS, ids=SPLIT_IDS)
def test_cluster_running_fold_over_uneven_batches(split):
    dev = _cuda()
    frozen, records, _ = random_case(1)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    bounds = [0, 1, 700, 701, 2048, 2999, records.shape[0]]
    batches = [rec[s:e] for s, e in zip(bounds, bounds[1:])]
    got, want, acc_k, acc_p = _fold_both(ops, batches, "cluster", *split)
    assert torch.equal(got, want)
    _assert_same(acc_k, acc_p)
    _assert_oracle(frozen, records, got, acc_k)


@pytest.mark.parametrize("variant", [None, "cluster"])
@pytest.mark.parametrize("case", ["wide", "tpch_1300", "tpch_20000"])
def test_trees_past_one_block_take_the_plans_kernel(case, variant):
    """One launch a batch of each of the plan's kernels and no other fused
    kernel, for 160 columns x 200 leaves, and for 1,300 and 20,000 leaves
    over tpch-40M's schema and cuts: the leafwise design (1,300 and 20,000
    leaves), the global kernel where its route's warps do not fit (160
    columns); and the same with the cluster kernel forced (a cluster of 4,
    of 2, and of 16 in two ranges)."""
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records = (wide_case(0) if case == "wide"
                       else tpch_case(int(case[5:]), 5000))
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    shape = tfk.plan_shape(ops)
    optin = tfk.optin_bytes(dev.index)
    assert tfk.shared_warps_fit(shape, optin) < 4
    plan = tfk.layout_plan(shape, optin, variant)
    names = tfk.KERNEL_NAMES[plan.kernel]
    assert plan.kernel == tfk.VARIANTS[
        variant or ("global" if case == "wide" else "leafwise")]
    before = _build.launch_counts()
    got, want, acc_k, acc_p = _fold_both(ops, [rec[:1], rec[1:777],
                                               rec[777:]], variant)
    after = _build.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: 3 * (k in names) for k in after}
    assert acc_k._launch == plan._replace(most=acc_k._launch.most)
    if variant:
        assert acc_k._launch.warps >= 4 and acc_k._launch.most >= 1
        assert acc_k._launch.cluster == {"wide": 4, "tpch_1300": 2,
                                         "tpch_20000": 16}[case]
        assert (acc_k._launch.ranges > 1) == (case == "tpch_20000")
    assert torch.equal(got, want)
    _assert_same(acc_k, acc_p)
    _assert_oracle(frozen, records, got, acc_k)


@pytest.mark.parametrize("split", [(4, 1), (16, 2)], ids=["c4r1", "c16r2"])
def test_cluster_kernel_folds_rows_past_a_full_inbox(split):
    """Every row owned by one block: each other block of its range sends it
    all its rows, more a round than its inbox holds (two entries a peer
    lane), so the rest (a third at 4 blocks, 13 of 15 at 16) are folded by
    their senders straight into the owner's slice."""
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records, _ = random_case(3)
    c, r = split
    leaf = frozen.route(records)
    owner = (leaf % r) * c + (leaf // r) % c  # (range, block), as one
    busiest = np.bincount(owner).argmax()
    host = np.resize(records[owner == busiest], ((1 << 16) + 5,
                                                 records.shape[1]))
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    before = _build.launch_counts()
    got, want, acc_k, acc_p = _fold_both(
        ops, [torch.from_numpy(host).to(dev)], "cluster", *split)
    after = _build.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == "fused_ingest_cluster") for k in after}
    # the cluster's first round fills every warp's tile
    assert host.shape[0] >= 32 * c * acc_k._launch.warps
    assert torch.equal(got, want)
    _assert_same(acc_k, acc_p)
    _assert_oracle(frozen, host, got, acc_k)


def test_cluster_plans_on_the_card():
    """The card takes the cluster kernel's plan at every cluster size the
    shapes reach, a cluster of 16 (past the portable 8) and two ranges
    included; unforced, the plan takes the leafwise design at every one
    of these sizes."""
    dev = _cuda()
    optin = tfk.optin_bytes(dev.index)
    for L in (1250, 3000, 7500, 8000, 20000):
        shape = (L, 21, 5, 1, 11, 3)
        plan = tfk.device_plan(dev.index, shape, "cluster")
        assert plan._replace(most=0) == tfk.layout_plan(shape, optin,
                                                        "cluster")
        assert plan.kernel == 3 and plan.most >= 1
        assert tfk.device_plan(dev.index, shape).kernel == 4


def test_a_refused_cluster_raises_and_leaves_no_error():
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records = wide_case(0)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    before = _build.launch_counts()
    # a cluster past what the card schedules: CUDA refuses it
    with pytest.raises(RuntimeError, match="fused_ingest kernel launch"):
        with tfk._forced("cluster", 32):
            tfk.IngestAccumulator(ops)
    # warps whose tiles do not fit beside a block's slice
    with pytest.raises(ValueError, match="do not fit"):
        tfk.IngestAccumulator(ops, launch=("cluster", 32, 0))
    # a tree that fits one block is the shared kernel's
    small, _, _ = random_case(0)
    with pytest.raises(ValueError, match="shared kernel takes it"):
        tfk.IngestAccumulator(
            tplan.to_device(tplan.pack_route_constants(small), dev),
            launch=("cluster", 8, 0))
    assert _build.launch_counts() == before
    # nothing is left behind for the next launch
    got, want, acc_k, acc_p = _fold_both(ops, [rec], None)
    assert torch.equal(got, want)
    _assert_same(acc_k, acc_p)


def test_autotune_pins_a_cluster_geometry(tmp_path, monkeypatch):
    """The default grid holds shared, cluster and global candidates; on a
    tree past one block the shared candidates are skipped, a cluster one
    is chosen from a grid of cluster ones, and the engine's accumulator
    launches it."""
    from repro_torch.engine import autotune
    from repro_torch.engine import backends as tbe
    from repro_torch.kernels import _build

    dev = _cuda()
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_STORE", str(tmp_path / "a.json"))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = autotune.default_grid(sms)
    variants = {v for v, _, _ in grid}
    assert variants == {"shared", "cluster", "leafwise", "global"}
    frozen, records = wide_case(1)
    rec = torch.from_numpy(records).to(dev)
    eng = LayoutEngine(frozen)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    most = tfk.layout_plan(tfk.plan_shape(ops), tfk.optin_bytes(dev.index),
                           "cluster")
    assert most.warps > 4  # the most warps that fit
    out = autotune.autotune_fused(
        frozen, rec, engine=eng, reps=2,
        grid=[("shared", 8, sms), ("cluster", 4, 0),
              ("cluster", most.warps, 0), ("cluster", most.warps + 1, 0)])
    status = {(r["variant"], r["warps"]): r["status"] for r in out["rows"]}
    assert status == {("shared", 8): "skipped", ("cluster", 4): "ok",
                      ("cluster", most.warps): "ok",
                      ("cluster", most.warps + 1): "skipped"}
    chosen = autotune.lookup("cuda", autotune.geometry_key(frozen))
    assert chosen.variant == "cluster"
    acc = tbe.get_backend("torch").accumulator(frozen, tplan.PlanCache(), dev)
    assert acc.launch == chosen.launch
    assert acc.acc._launch.warps == chosen.warps
    before = _build.launch_counts()["fused_ingest_cluster"]
    acc.fold(rec)
    assert _build.launch_counts()["fused_ingest_cluster"] == before + 1


# grown trees over tpch-40M's schema and cuts past one block: the plan
# folds each with the leafwise design
LEAFWISE_TREES = [1800, 8000, 20_000]


def _assert_leafwise_scratch(acc, n_leaves, ids):
    """What one batch left in a fresh accumulator's leafwise scratch: the
    scatter zeroed the per-leaf counts for the next batch, the scan left
    each leaf's first slot, the slots are each row's place among its leaf's
    rows, and the leaf order, each leaf's rows sorted, is the stable
    argsort of the block ids."""
    (s,) = acc._scratch.values()
    m = ids.shape[0]
    hist = torch.bincount(ids.long(), minlength=n_leaves)
    first = torch.cumsum(hist, 0) - hist
    assert not s["hist"].any()
    assert torch.equal(s["offsets"][:n_leaves].long(), first)
    assert int(s["offsets"][n_leaves]) == m
    slots = s["slots"][:m].long()
    assert (slots < hist[ids.long()]).all() and (slots >= 0).all()
    ent = torch.sort(s["entries"][:m]).values  # (leaf, row) order
    assert torch.equal(ent >> 32, torch.sort(ids).values.long())
    assert torch.equal(ent & 0xFFFFFFFF, torch.argsort(ids, stable=True))


@pytest.mark.parametrize("case", ["wide", *map(str, LEAFWISE_TREES)])
def test_leafwise_matches_plain_and_oracle(case):
    """The leafwise design, forced (on wide_case, 160 columns: five column
    groups a lane; the plan's on the grown trees), over a
    one-row batch and two more into one running accumulator: block ids and
    aggregates equal to the plain version and to the numpy oracle; the
    scratch after one batch holds each stage's output."""
    dev = _cuda()
    frozen, records = (wide_case(0) if case == "wide"
                       else tpch_case(int(case), 20_000))
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    shape = tfk.plan_shape(ops)
    planned = tfk.layout_plan(shape, tfk.optin_bytes(dev.index))
    takes = case != "wide"
    assert (planned.kernel == tfk.VARIANTS["leafwise"]) == takes
    got, want, acc_k, acc_p = _fold_both(
        ops, [rec[:1], rec[1:7777], rec[7777:]], "leafwise")
    assert acc_k._launch.kernel == tfk.VARIANTS["leafwise"]
    if takes:
        assert acc_k._launch == planned._replace(most=acc_k._launch.most)
    assert torch.equal(got, want)
    _assert_same(acc_k, acc_p)
    _assert_oracle(frozen, records, got, acc_k)
    with tfk._forced("leafwise"):
        acc = tfk.IngestAccumulator(ops)
    ids = acc.fold(rec, bids=True)
    torch.cuda.synchronize()
    assert torch.equal(ids, want)
    _assert_leafwise_scratch(acc, frozen.n_leaves, ids)


def test_leafwise_folds_a_batch_in_one_leaf():
    """2**16 + 5 rows, every one in the busiest leaf of 1,800: the fold
    splits the leaf over 1,025 chunks of csrc's kChunk (64) rows, the last
    of five."""
    dev = _cuda()
    frozen, records = tpch_case(1800, 5000)
    ids = frozen.route(records)
    host = np.resize(records[ids == np.bincount(ids).argmax()],
                     ((1 << 16) + 5, records.shape[1]))
    assert np.unique(frozen.route(host)).size == 1
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(host).to(dev)
    got, want, acc_k, acc_p = _fold_both(ops, [rec], "leafwise")
    assert torch.equal(got, want)
    _assert_same(acc_k, acc_p)
    _assert_oracle(frozen, host, got, acc_k)


def test_leafwise_folds_one_row():
    dev = _cuda()
    frozen, records, _ = random_case(0)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records[:1]).to(dev)
    got, want, acc_k, acc_p = _fold_both(ops, [rec], "leafwise")
    assert torch.equal(got, want)
    _assert_same(acc_k, acc_p)
    _assert_leafwise_scratch(acc_k, frozen.n_leaves, got)


@pytest.mark.parametrize("n_leaves", LEAFWISE_TREES)
def test_engine_ingest_launches_the_plans_kernels_once_a_batch(n_leaves):
    from repro_torch.engine import sharded
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records = tpch_case(n_leaves, 20_000)
    rec = torch.from_numpy(records).to(dev)
    oracle = _fresh(frozen)
    LayoutEngine(oracle, backend="numpy", device="cpu").ingest(
        sharded.micro_batches(records, 7777))
    tree = _fresh(frozen)
    eng = LayoutEngine(tree)
    _build.reset_launch_counts()
    rep = eng.ingest(sharded.micro_batches(rec, 7777))
    counts = _build.launch_counts()
    names = tfk.KERNEL_NAMES[tfk.VARIANTS["leafwise"]]
    assert rep.n_batches == 3
    assert {k: counts[k] for k in _build.LAUNCH_NAMES} == {
        k: 3 * (k in names) for k in _build.LAUNCH_NAMES}
    for a, b in zip(_leaf_arrays(tree), _leaf_arrays(oracle)):
        np.testing.assert_array_equal(a, b)


def _profiled_ingests(eng, rec, passes=3):
    """The program's spans and the profiler's events of ``passes`` ingests
    of ``rec`` in 7,777-row batches, in one profiled session."""
    from repro_torch import tracing
    from repro_torch.engine import sharded

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        tracing.start()
        for _ in range(passes):
            eng.ingest(sharded.micro_batches(rec, 7777))
        torch.cuda.synchronize()
        spans = tracing.stop()
    return spans, list(prof.profiler.kineto_results.events())


def _clock_margins(spans, events, kernels_a_batch):
    """Least ns by which (host) each ``fused_ingest.launch`` span holds the
    CUDA calls that launched its batch's kernels, as the profiler stamps
    them; (device) a kernel starts after its call; (copy) a copy back lies
    inside its ``ingest.partial.copy`` span.  Negative: out by that much."""
    launches = sorted((s, e) for name, s, e in spans
                      if name == "fused_ingest.launch")
    device = [e for e in events if e.device_type().name == "CUDA"]
    calls = {e.correlation_id(): e for e in events
             if e.device_type().name != "CUDA"}
    kernels = sorted((e for e in device if "fused_ingest" in e.name()),
                     key=lambda e: e.start_ns())
    assert len(kernels) == kernels_a_batch * len(launches)
    host, dev = [], []
    for i, k in enumerate(kernels):
        call = calls[k.correlation_id()]
        s, e = launches[i // kernels_a_batch]
        host.append(min(call.start_ns() - s, e - call.end_ns()))
        dev.append(k.start_ns() - call.start_ns())
    copies = sorted((e.start_ns(), e.end_ns()) for e in device
                    if "DtoH" in e.name())
    windows = sorted((s, e) for name, s, e in spans
                     if name == "ingest.partial.copy")
    assert len(copies) == len(windows)
    copy = [min(a - s, e - b) for (a, b), (s, e) in zip(copies, windows)]
    return min(host), min(dev), min(copy)


@pytest.mark.parametrize("n_leaves", [724, LEAFWISE_TREES[0]])
def test_ingest_spans_share_the_profilers_clock(n_leaves):
    """The program's spans are on the profiler's host clock: each
    ``fused_ingest.launch`` span holds the CUDA calls that queued its
    batch's kernels, as the profiler stamps them, to 20 us, in each of two
    profiled sessions; a batch is one launch span.  In a session this short
    the profiler's device stamps keep to its host stamps to 0.25 ms (one
    can stamp the device early, PERF.md §6): each kernel starts after its
    call and each copy back of ``partial`` lies inside its
    ``ingest.partial.copy`` span, to that."""
    from repro_torch.engine import sharded
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records = tpch_case(n_leaves, 40_000)
    rec = torch.from_numpy(records).to(dev)
    eng = LayoutEngine(_fresh(frozen))
    eng.ingest(sharded.micro_batches(rec, 7777))  # warm
    torch.cuda.synchronize()
    for session in ("first", "second"):
        before = _build.launch_counts()
        spans, events = _profiled_ingests(eng, rec)
        moved = {k: n - before[k] for k, n in _build.launch_counts().items()
                 if k.startswith("fused_ingest") and n != before[k]}
        # the plan's design: one kernel a batch, or the leafwise design's
        # four
        assert len(moved) in (1, 4) and len(set(moved.values())) == 1
        launches = [s for s in spans if s[0] == "fused_ingest.launch"]
        assert len(launches) == sum(moved.values()) // len(moved) == 3 * 6
        host, device, copy = _clock_margins(spans, events, len(moved))
        print(f"{n_leaves} leaves, {session} session: least margins (ns) "
              f"host {host}, device {device}, copy {copy}")
        assert host >= -20_000
        assert min(device, copy) >= -250_000


def test_a_refused_leafwise_shape_raises_and_leaves_no_error():
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records = wide_case(0)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    before = _build.launch_counts()
    # 32 warps' tiles of 160 columns are past a block's bytes: CUDA refuses
    with pytest.raises(RuntimeError, match="fused_ingest kernel launch"):
        with tfk._forced("leafwise", warps=32):
            tfk.IngestAccumulator(ops)
    # pinned, the same geometry is refused before the card is asked
    with pytest.raises(ValueError, match="do not fit"):
        tfk.IngestAccumulator(ops, launch=("leafwise", 32, 0))
    # a tree that fits one block is the shared kernel's
    small, _, _ = random_case(0)
    with pytest.raises(ValueError, match="shared kernel takes it"):
        tfk.IngestAccumulator(
            tplan.to_device(tplan.pack_route_constants(small), dev),
            launch=("leafwise", 21, 0))
    # past the fold's 256 columns
    wider, _ = wide_case(0, d=257, m=600, leaves=20)
    with pytest.raises(ValueError, match="leafwise fold takes at most"):
        with tfk._forced("leafwise"):
            tfk.IngestAccumulator(
                tplan.to_device(tplan.pack_route_constants(wider), dev))
    assert _build.launch_counts() == before
    # nothing is left behind for the next launch
    got, want, acc_k, acc_p = _fold_both(ops, [rec], "leafwise")
    assert torch.equal(got, want)
    _assert_same(acc_k, acc_p)


def test_a_failed_leafwise_launch_drops_its_streams_scratch(monkeypatch):
    """A launch whose later stage fails may leave the batch's per-leaf
    counts, zero on entry, in the stream's scratch: the wrapper raises and
    drops that scratch, so the next batch on the stream folds exactly."""
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records = tpch_case(1800, 5000)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    with tfk._forced("leafwise"):
        acc = tfk.IngestAccumulator(ops)
    acc.fold(rec)
    (scratch,) = acc._scratch.values()
    lib = _build.library("fused_ingest")

    class FailsAfterTheRoute:
        def fused_ingest_launch(self, *args):
            assert lib.fused_ingest_launch(*args) == 0
            scratch["hist"].fill_(1)  # counts a stage did not clear
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(_build, "library", lambda name: FailsAfterTheRoute())
    with pytest.raises(RuntimeError, match="fused_ingest kernel launch"):
        acc.fold(rec)
    assert not acc._scratch
    monkeypatch.undo()
    acc.fold(rec)
    plain = tfk.IngestAccumulator(ops)
    for _ in range(3):
        tfk.fused_ingest_plain(rec, plain)
    torch.cuda.synchronize()
    _assert_same(acc, plain)


def test_leafwise_folds_from_eight_streams_into_one_accumulator():
    """Eight threads, each on its own stream, fold their slices into one
    accumulator: the merges are atomic and each stream has its own
    scratch, so the result is the plain version's over every slice."""
    import threading

    dev = _cuda()
    frozen, records = tpch_case(1800, 40_000)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    with tfk._forced("leafwise"):
        acc = tfk.IngestAccumulator(ops)
    torch.cuda.synchronize()
    slices = rec.chunk(8)

    def fold(x):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            for _ in range(3):
                acc.fold(x)
            torch.cuda.current_stream(dev).synchronize()

    threads = [threading.Thread(target=fold, args=(x,)) for x in slices]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    plain = tfk.IngestAccumulator(ops)
    for _ in range(3):
        tfk.fused_ingest_plain(rec, plain)
    _assert_same(acc, plain)
    assert len(acc._scratch) == 8


def test_autotune_pins_a_leafwise_geometry(tmp_path, monkeypatch):
    """On 8,000 grown leaves the leafwise candidates run, and a pinned one
    folds through the leafwise kernels."""
    from repro_torch.engine import autotune
    from repro_torch.engine import backends as tbe
    from repro_torch.kernels import _build

    dev = _cuda()
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_STORE", str(tmp_path / "a.json"))
    frozen, records = tpch_case(8000, 20_000)
    rec = torch.from_numpy(records).to(dev)
    eng = LayoutEngine(frozen)
    out = autotune.autotune_fused(
        frozen, rec, engine=eng, reps=2,
        grid=[("leafwise", w, 0) for w in autotune.LEAFWISE_WARPS])
    assert all(r["status"] == "ok" for r in out["rows"])
    chosen = autotune.lookup("cuda", autotune.geometry_key(frozen))
    assert chosen.variant == "leafwise"
    acc = tbe.get_backend("torch").accumulator(frozen, tplan.PlanCache(), dev)
    assert acc.launch == chosen.launch
    assert acc.acc._launch.warps == chosen.warps
    before = _build.launch_counts()
    acc.fold(rec)
    after = _build.launch_counts()
    names = tfk.KERNEL_NAMES[tfk.VARIANTS["leafwise"]]
    assert {k: after[k] - before[k] for k in names} == dict.fromkeys(names, 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_query_intersect_kernel_matches_plain(seed):
    dev = _cuda()
    frozen, records, work = random_case(seed)
    frozen.tighten(records, frozen.route(records))
    wt = work.tensorize(frozen.cuts)
    layout = tops.query_layout(frozen.schema, frozen.cuts.n_adv)
    args = (
        tplan.to_device(tplan.pack_leaf_descs(frozen, layout), dev),
        tplan.to_device(tops.pack_workload(wt, layout), dev),
        tplan.to_device(layout, dev),
    )
    from repro_torch.kernels import _build

    before = _build.launch_counts()["query_intersect"]
    got = tqk.query_intersect(*args)
    assert _build.launch_counts()["query_intersect"] == before + 1
    torch.cuda.synchronize()
    for a, b in zip(got, tqk.query_intersect_plain(*args)):
        assert torch.equal(a, b)
    conj = qry.conjuncts_intersect(
        frozen.leaf_lo, frozen.leaf_hi, frozen.leaf_cat, frozen.leaf_adv,
        wt, frozen.schema,
    )
    np.testing.assert_array_equal(got[0].cpu().numpy().astype(bool), conj)


@pytest.mark.parametrize("n_num", [34, 36])
def test_query_intersect_near_the_default_shared_limit(n_num):
    """Widths whose dynamic shared memory lies between the default limit
    less the kernel's static 4 KB and 48 KB: the launch raises its limit."""
    from repro_torch.kernels import _build

    dev = _cuda()
    rng = np.random.default_rng(n_num)
    schema = preds.Schema((
        *(preds.Column(f"x{j}", "numeric", 100) for j in range(n_num)),
        preds.Column("c", "categorical", 32),
    ))
    layout = tops.query_layout(schema, 0)
    L, C = 1024, 45
    kl = kc = 2 * n_num + 3  # one categorical word and entry, two adv words
    smem = 4 * (32 * kc + 1 + 1 + 128 * kl)
    assert 48 * 1024 - 4096 < smem <= 48 * 1024
    lo = rng.integers(0, 60, (L, n_num))
    i32 = np.iinfo(np.int32)
    q_lo = np.full((C, n_num), i32.min)
    q_hi = np.full((C, n_num), i32.max)
    q_lo[:, :2] = rng.integers(0, 90, (C, 2))
    q_hi[:, :2] = q_lo[:, :2] + rng.integers(1, 20, (C, 2))
    leaf = {
        "desc": np.concatenate([
            lo, lo + rng.integers(1, 40, (L, n_num)),
            rng.integers(0, 2**31, (L, 1)), rng.integers(0, 2**31, (L, 2)),
        ], axis=1).astype(np.int32),
        "size": rng.integers(0, 2**40, L).astype(np.int64),
    }
    conj = {"desc": np.concatenate([
        q_lo, q_hi, rng.integers(1, 2**31, (C, 1)),
        rng.integers(0, 2**31, (C, 2)) & (rng.random((C, 2)) < 0.3),
    ], axis=1).astype(np.int32)}
    assert leaf["desc"].shape[1] == kl and conj["desc"].shape[1] == kc
    args = tuple(tplan.to_device(x, dev) for x in (leaf, conj, layout))
    before = _build.launch_counts()["query_intersect"]
    got = tqk.query_intersect(*args)
    assert _build.launch_counts()["query_intersect"] == before + 1
    torch.cuda.synchronize()
    want = tqk.query_intersect_plain(*args)
    assert 0 < int(want[0].sum()) < L * C
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
        tfk.IngestAccumulator(host_ops).fold(rec)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    with pytest.raises(ValueError, match="columns"):
        trk.eval_cuts(rec[:, :3].contiguous(), ops)
    with pytest.raises(ValueError, match="int32"):
        trk.eval_cuts(rec.to(torch.int64), ops)
    with pytest.raises(ValueError, match="not cuda"):
        trk.route(rec, host_ops)
    with pytest.raises(ValueError, match="not cpu"):
        trk.route(rec.cpu(), ops)
    with pytest.raises(ValueError, match="columns"):
        trk.route(rec[:, :3].contiguous(), ops)
    with pytest.raises(ValueError, match="int32"):
        trk.route(rec.to(torch.int64), ops)
    with pytest.raises(ValueError, match="int32"):
        trk.route(rec.t(), ops)  # not contiguous


def _leaf_arrays(tree):
    return [getattr(tree, f).copy() for f in
            ("leaf_lo", "leaf_hi", "leaf_cat", "leaf_adv", "block_sizes")]


def _fresh(frozen):
    from repro_torch.core.qdtree import FrozenQdTree

    return FrozenQdTree.from_arrays(frozen.to_arrays())


@pytest.mark.parametrize("k", [1, 4])
def test_thread_shards_on_streams_match_one_stream(k):
    """k thread shards, each on its own CUDA stream with its own device
    accumulator, publish what one stream's ingest publishes; one
    ``fused_ingest`` launch a batch."""
    import warnings

    from repro_torch.engine import sharded
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records, _ = random_case(3, m=20_000)
    rec = torch.from_numpy(records).to(dev)
    one = _fresh(frozen)
    LayoutEngine(one).ingest(sharded.micro_batches(rec, 777))
    tree = _fresh(frozen)
    eng = LayoutEngine(tree)
    _build.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", sharded.PerformanceWarning)
        rep = sharded.sharded_ingest(eng, rec, k, batch=777,
                                     executor="thread")
    counts = _build.launch_counts()
    assert rep.n_batches == sum(
        -(-p.shape[0] // 777) for p in sharded.shard_slices(rec, k))
    assert tfk.batches_folded(counts) == rep.n_batches
    for a, b in zip(_leaf_arrays(tree), _leaf_arrays(one)):
        np.testing.assert_array_equal(a, b)


def test_launch_counts_exact_from_eight_threads():
    import threading

    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records, _ = random_case(1)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    rec = torch.from_numpy(records).to(dev)
    accs = [tfk.IngestAccumulator(ops) for _ in range(8)]
    (name,) = tfk.KERNEL_NAMES[accs[0]._launch.kernel]
    _build.reset_launch_counts()

    def fold(acc):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            for _ in range(50):
                acc.fold(rec)
            torch.cuda.current_stream(dev).synchronize()

    threads = [threading.Thread(target=fold, args=(a,)) for a in accs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert _build.launch_counts()[name] == 8 * 50


def test_tuned_geometry_matches_the_analytic_plan(tmp_path, monkeypatch):
    """The autotuner's chosen geometry, looked up by the engine's
    accumulator, folds what the analytic plan folds."""
    from repro_torch.engine import autotune
    from repro_torch.engine import backends as tbe

    dev = _cuda()
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_STORE", str(tmp_path / "a.json"))
    frozen, records, _ = random_case(7, m=20_000)
    rec = torch.from_numpy(records).to(dev)
    eng = LayoutEngine(frozen)
    out = autotune.autotune_fused(frozen, rec, reps=2, engine=eng)
    assert any(r["status"] == "ok" for r in out["rows"])
    chosen = autotune.lookup("cuda", autotune.geometry_key(frozen))
    assert chosen is not None and chosen.to_dict() == out["chosen"]
    torch_be = tbe.get_backend("torch")
    tuned = torch_be.accumulator(frozen, tplan.PlanCache(), dev)
    assert tuned.launch == chosen.launch
    analytic = tbe.DeviceAccumulator(
        frozen, tplan.to_device(tplan.pack_route_constants(frozen), dev), dev)
    for acc in (tuned, analytic):
        for s in range(0, rec.shape[0], 3001):
            acc.fold(rec[s:s + 3001])
    a, b = tuned.partial(), analytic.partial()
    for f in ("counts", "lo", "hi", "cat", "adv"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    with pytest.raises(ValueError, match="warps"):
        torch_be.accumulator(frozen, tplan.PlanCache(), dev,
                             launch=("shared", 64, 132))


def test_block_buffers_device_sort_matches_host():
    from repro_torch.data.blocks import BlockBuffers

    dev = _cuda()
    frozen, records, _ = random_case(0, m=20_000)
    host, on_card = BlockBuffers.for_tree(frozen), BlockBuffers.for_tree(
        frozen)
    eng = LayoutEngine(_fresh(frozen))
    for s in range(0, records.shape[0], 4099):
        batch = records[s:s + 4099]
        bids = frozen.route(batch)
        host.append(batch, bids)
        on_card.append(torch.from_numpy(batch).to(dev),
                       torch.from_numpy(bids).to(dev))
    spilled = BlockBuffers.for_tree(frozen)
    eng.ingest([torch.from_numpy(records[s:s + 4099]).to(dev)
                for s in range(0, records.shape[0], 4099)], buffers=spilled)
    for buf in (on_card, spilled):
        np.testing.assert_array_equal(buf.sizes, host.sizes)
        for b in range(frozen.n_leaves):
            np.testing.assert_array_equal(buf.block(b), host.block(b))


def test_tree_env_cut_matrix_is_one_eval_cuts_launch():
    """WOODBLOCK's env evaluates its sample's cut matrix in one
    ``eval_cuts`` launch, bit for bit ``preds.eval_cuts``."""
    from repro_torch.core.woodblock.env import TreeEnv
    from repro_torch.kernels import _build

    _cuda()
    frozen, records, work = random_case(2, m=5000)
    _build.reset_launch_counts()
    env = TreeEnv(records, work, frozen.cuts, min_block_sample=50)
    assert env.device.type == "cuda"
    assert _build.launch_counts()["eval_cuts"] == 1
    np.testing.assert_array_equal(env.cut_matrix,
                                  preds.eval_cuts(records, frozen.cuts))


def test_device_observation_probe_equals_host_probe():
    """An engine on the card scores each observed batch on the device
    (per-leaf counts as an int64 tensor, ids never copied back): every
    WindowStat equals the host probe's over the numpy route."""
    from repro_torch.engine import sharded

    dev = _cuda()
    frozen, records, work = random_case(4, m=20_000)
    eng = LayoutEngine(_fresh(frozen))
    probe = eng.observation_probe(work)
    assert probe.on_device is not None and probe.on_device.device == dev
    assert probe.on_device.dtype == torch.int64
    rec = torch.from_numpy(records).to(dev)
    seen = []
    rep = eng.ingest(sharded.micro_batches(rec, 1111), observe=probe,
                     on_observation=seen.append)
    host = probe.per_leaf
    want = [
        (int(host[frozen.route(records[s:s + 1111])].sum()),
         min(1111, records.shape[0] - s) * probe.n_queries)
        for s in range(0, records.shape[0], 1111)
    ]
    assert [(w.scanned_tuples, w.capacity) for w in seen] == want
    assert rep.observation.scanned_tuples == sum(w[0] for w in want)


def test_release_during_thread_sharded_ingest_on_card(monkeypatch):
    """A generation swapped out and released while its thread shards run
    on their streams: the stale run's merged state equals the numpy
    oracle's, and the new generation routes like numpy."""
    import threading
    import warnings

    from repro_torch.core.qdtree import IncrementalTightener
    from repro_torch.engine import sharded
    from repro_torch.service import IngestOptions, LayoutBuild, LayoutService

    dev = _cuda()
    frozen, records, _ = random_case(6, m=40_000)
    other, _, _ = random_case(7, m=40_000)
    svc = LayoutService(_fresh(frozen))
    old = svc.live_version()
    rec = torch.from_numpy(records).to(dev)
    svc.route(rec[:100])  # the old generation's plan exists
    started, go = threading.Event(), threading.Event()
    orig = sharded._run_shard

    def gated(ingestor, batches):
        started.set()
        assert go.wait(30)
        return orig(ingestor, batches)

    monkeypatch.setattr(sharded, "_run_shard", gated)
    out = []

    def run():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", sharded.PerformanceWarning)
            out.append(svc.ingest(
                rec, IngestOptions(shards=4, executor="thread", batch=3001),
                keep_state=True))

    t = threading.Thread(target=run)
    t.start()
    assert started.wait(30)
    svc.swap(LayoutBuild(tree=_fresh(other), bids=np.zeros(0, np.int32),
                         strategy="adopted", build_s=0.0, metrics={},
                         provenance={}))
    assert svc.release(old.generation) > 0
    go.set()
    t.join(60)
    (rep,) = out
    assert rep.stale_generation and not rep.published
    want = IncrementalTightener(frozen)
    want.update(records, frozen.route(records))
    for f in ("counts", "lo", "hi", "cat", "adv"):
        np.testing.assert_array_equal(getattr(rep.state, f),
                                      getattr(want, f), f)
    np.testing.assert_array_equal(svc.route(rec), other.route(records))


def test_ppo_update_on_card_matches_cpu():
    """One PPO update and one sampling step of the WOODBLOCK net on the
    card against the same on the CPU (float32, another summation order)."""
    from repro_torch.core.woodblock import networks, ppo
    from repro_torch.core.woodblock.env import Transition

    dev = _cuda()
    rng = np.random.default_rng(0)
    feat, acts, n = 96, 40, 300
    trans = [
        Transition(state=rng.integers(0, 2, feat).astype(np.float32),
                   legal=rng.random(acts) < 0.5, action=0,
                   logp=float(-rng.random()), value=float(rng.random()),
                   node_key=i, reward=float(rng.random()))
        for i in range(n)
    ]
    for t in trans:
        t.legal[0] = True
    cpu = networks.make_net(feat, acts, torch.Generator().manual_seed(1))
    card = networks.make_net(feat, acts, torch.Generator().manual_seed(1),
                             device=dev)
    with torch.no_grad():
        for (_, a), (_, b) in zip(cpu.named_parameters(),
                                  card.named_parameters()):
            b.copy_(a)
    cfg = ppo.PPOConfig()
    cpu, ocpu, _ = ppo.ppo_update(
        cpu, ppo.adam_init(cpu), ppo.make_batch(trans, n, acts, feat), cfg)
    card, ocard, _ = ppo.ppo_update(
        card, ppo.adam_init(card),
        ppo.make_batch(trans, n, acts, feat, device=dev), cfg)
    for (k, a), (_, b) in zip(cpu.named_parameters(),
                              card.named_parameters()):
        np.testing.assert_allclose(b.detach().cpu().numpy(),
                                   a.detach().numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    batch = ppo.make_batch(trans, n, acts, feat, device=dev)
    a, lp, v = ppo.policy_step(card, batch["states"], batch["legal"],
                               torch.Generator(device=dev).manual_seed(3))
    assert a.device == dev and batch["legal"][torch.arange(n), a].all()


def _serve_pair(seed):
    """The same tightened tree served on the card and on the CPU, and a
    second tree to hot-swap to."""
    from repro_torch.service import LayoutService

    frozen, records, work = random_case(seed, m=20_000)
    frozen.tighten(records, frozen.route(records))
    other, other_records, _ = random_case(seed + 10, m=20_000)
    other.tighten(other_records, other.route(other_records))
    return (LayoutService(_fresh(frozen)),
            LayoutService(_fresh(frozen), device="cpu"), other, work)


def _adopt(tree):
    from repro_torch.service.service import _adopt_tree

    return _adopt_tree(_fresh(tree))


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_on_card_matches_serve_on_cpu(seed):
    """Sync rounds of a repeated mix with a hot swap in the middle: every
    response and every counter on the card equals the CPU's; each engine
    dispatch is one ``query_intersect`` launch; after ``warm`` the card
    builds no plan outside the swap."""
    from repro_torch.kernels import _build
    from repro_torch.serve import QueryServer, ServeConfig

    _cuda()
    gpu, cpu, other, work = _serve_pair(seed)
    rng = np.random.default_rng(seed)
    mix = [work.queries[int(i)] for i in rng.integers(0, len(work), 200)]
    servers = [QueryServer(s, ServeConfig(max_batch=16)) for s in (gpu, cpu)]
    servers[0].warm(work)
    got, want = [], []
    builds = {}
    launched = 0
    for r in range(0, len(mix), 16):
        if r == 96:
            gpu.swap(_adopt(other))
            cpu.swap(_adopt(other))
            servers[0].warm(work)
        before = tplan.build_counts()
        n0 = _build.launch_counts()["query_intersect"]
        d0 = servers[0].counters.engine_dispatches
        got += servers[0].serve_batch(mix[r:r + 16])
        launched += _build.launch_counts()["query_intersect"] - n0
        assert (_build.launch_counts()["query_intersect"] - n0
                == servers[0].counters.engine_dispatches - d0)
        for k, n in tplan.build_delta(before, tplan.build_counts()).items():
            builds[k] = builds.get(k, 0) + n
        want += servers[1].serve_batch(mix[r:r + 16])
    assert builds == {}
    assert launched > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.bids, b.bids)
        assert (a.generation, a.desc_version, a.cached) == (
            b.generation, b.desc_version, b.cached)
    sa, sb = (s.stats() for s in servers)
    sa.pop("latency"), sb.pop("latency")
    assert sa == sb and sa["counters"]["stale_responses"] == 0
    for s in servers:
        s.stop()


def test_async_serve_on_card_under_concurrent_swaps():
    """Three client threads through the dispatcher on the card while the
    main thread hot-swaps: no stale response, each equal to its
    generation's numpy route, and a kernel error fails the tickets."""
    import threading
    import time

    from repro_torch.engine import backends as be
    from repro_torch.serve import QueryServer, ServeConfig

    _cuda()
    gpu, _, other, work = _serve_pair(3)
    builds = [_adopt(other), _adopt(gpu.tree)]
    server = QueryServer(gpu, ServeConfig(max_batch=8)).start()
    server.warm(work)
    pairs, errors = [], []

    def client(tid):
        rng = np.random.default_rng(tid)
        try:
            for _ in range(60):
                q = work.queries[int(rng.integers(0, len(work)))]
                pairs.append((q, server.serve(q, timeout=60.0)))
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for i in range(4):
        time.sleep(0.01)
        gpu.swap(builds[i % 2])
    for t in threads:
        t.join()
    assert not errors, errors[0]
    assert server.counters.stale_responses == 0 and len(pairs) == 180
    for q, res in pairs:
        tree = gpu.version(res.generation).tree
        oracle = LayoutEngine(tree, backend="numpy", device="cpu")
        np.testing.assert_array_equal(res.bids, oracle.route_query(q))
    real = be.get_backend("torch").query_intersect

    def boom(*a, **k):
        raise RuntimeError("kernel failed")

    be.get_backend("torch").query_intersect = boom
    try:
        fresh = [q for q in work.queries][:2]
        gpu.swap(builds[0])  # a new epoch: both queries miss
        tickets = [server.submit(q) for q in fresh]
        for t in tickets:
            with pytest.raises(RuntimeError, match="kernel failed"):
                t.result(timeout=60.0)
    finally:
        be.get_backend("torch").query_intersect = real
        server.stop()


def test_coordinator_folds_thread_shards_on_card():
    """``IngestOptions(coordinator=)`` with thread shards on the card
    publishes what one CPU stream tightens."""
    import warnings

    from repro_torch.coordinator import FleetCoordinator
    from repro_torch.engine import sharded
    from repro_torch.service import IngestOptions, LayoutService

    dev = _cuda()
    frozen, records, _ = random_case(5, m=30_000)
    svc = LayoutService(_fresh(frozen))
    coord = FleetCoordinator(svc, cadence=2)
    rec = torch.from_numpy(records).to(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", sharded.PerformanceWarning)
        for half in torch.tensor_split(rec, 2):
            svc.ingest(half, IngestOptions(shards=4, batch=4001,
                                           coordinator=coord))
    assert coord.stats()["folds"] == 1
    want = _fresh(frozen)
    LayoutEngine(want, device="cpu").ingest([records])
    for f in ("leaf_lo", "leaf_hi", "leaf_cat", "leaf_adv"):
        np.testing.assert_array_equal(getattr(svc.tree, f),
                                      getattr(want, f), f)


# ---------------------------------------------------------------------------
# the LM serving path: plain torch ops on the card (no kernel of its own)
# ---------------------------------------------------------------------------
# float32 on the card (TF32 off) against the CPU: sums in another order
LM_RTOL, LM_ATOL = 1e-4, 1e-4
LM_GAP_TOL = 2 * LM_ATOL  # a greedy pick may differ below this top-2 gap


def _lm_forced(params, cfg, batch, tokens, max_seq):
    """Prefill logits, then each decode step's with ``tokens`` fed in."""
    b, plen = batch["tokens"].shape
    last, pre = lm_model.prefill(params, batch, cfg)
    caches, _ = lm_model.init_caches(cfg, b, max_seq, tokens.device)
    caches = serve_lm._splice(cfg, caches, pre, plen)
    steps = []
    for i in range(tokens.shape[1] - 1):
        lg, caches = lm_model.decode_step(params, caches, tokens[:, i:i + 1],
                                          plen + i, cfg)
        steps.append(lg)
    return torch.cat([last[:, None], torch.stack(steps, dim=1)], dim=1)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lm_reduced_arch_on_card_matches_cpu(arch):
    """Greedy generation on the card from CPU-drawn weights: the prefill
    and every step's logits equal the CPU port's fed the same tokens, and
    each token is the CPU's argmax unless its top-2 gap is a near tie."""
    dev = _cuda()
    cfg = get_config(arch).reduced(max_positions=64)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    cpu = torch.device("cpu")
    params, _ = lm_model.init_model(lm_common.make_generator(0, cpu), cfg)
    batch = serve_lm.make_batch(cfg, 2, 24, 0, cpu)
    res = serve_lm.generate(lm_model.to_device(params, dev), cfg,
                            lm_model.to_device(batch, dev), 8, 64)
    toks = res["tokens"].cpu()
    want = _lm_forced(params, cfg, batch, toks, 64)
    got = torch.cat([res["prefill_logits"][:, None], res["logits"]],
                    dim=1).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=LM_RTOL,
                               atol=LM_ATOL)
    top2 = want.topk(2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < LM_GAP_TOL
    assert not ((want.argmax(-1).to(toks.dtype) != toks) & ~near).any()


def test_lm_bf16_forward_keeps_tf32_off():
    """The LM path takes its speed from the configs' bf16, never from
    TF32: after a bf16 prefill on the card both switches are as set."""
    dev = _cuda()
    cfg = get_config("starcoder2-3b").reduced(compute_dtype="bfloat16",
                                              param_dtype="bfloat16")
    params, _ = lm_model.init_model(lm_common.make_generator(0, dev), cfg)
    logits, _ = lm_model.prefill(
        params, serve_lm.make_batch(cfg, 2, 16, 0, dev), cfg)
    assert logits.dtype == torch.bfloat16
    assert bool(torch.isfinite(logits.float()).all())
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_serve_lm_main_on_the_card(capsys):
    _cuda()
    gen = serve_lm.main(["--device", "cuda"])
    assert gen.shape == (4, 32) and ((gen >= 0) & (gen < 256)).all()
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["device"].startswith("cuda")


# ---------------------------------------------------------------------------
# LM training: plain torch ops and autograd on the card
# ---------------------------------------------------------------------------
# three train steps, float32 on the card against the CPU from one state:
# each float leaf within LM_RTOL of its own max |x| plus LM_TRAIN_ATOL (a
# leaf whose gradient is noise, such as a key bias, steps by ~lr either
# way); int8 moment codes within 1 (a rounding tie)
LM_TRAIN_ATOL = 1e-6


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "grok-1-314b",
                                  "mamba2-780m", "whisper-small"])
def test_lm_train_steps_on_card_match_cpu(arch):
    from repro_torch.train import optimizer as lm_opt
    from repro_torch.train import schedule as lm_sched
    from repro_torch.train import steps as lm_steps

    dev = _cuda()
    cfg = get_config(arch).reduced()
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    ocfg = lm_opt.AdamWConfig(eight_bit=cfg.opt_8bit)
    # int8 moments at lr 0: a moved run is chaotic (chip_smoke.py's
    # LM_TRAIN_CARD_LR says why); the moments still go through int8
    scfg = lm_sched.ScheduleConfig(peak_lr=0.0 if cfg.opt_8bit else 1e-3,
                                   warmup_steps=1, total_steps=10)
    cpu = torch.device("cpu")
    host = lm_steps.init_train_state(lm_common.make_generator(0, cpu), cfg,
                                     ocfg)
    card = lm_model.to_device(host, dev)
    rng = np.random.default_rng(0)
    for _ in range(3):
        batch = serve_lm.make_batch(cfg, 4, 32, int(rng.integers(1 << 30)),
                                    cpu)
        batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
        host, mh = lm_steps.train_step(host, batch, cfg, ocfg, scfg)
        card, mc = lm_steps.train_step(card, lm_model.to_device(batch, dev),
                                       cfg, ocfg, scfg)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(mc[k]), float(mh[k]),
                                       rtol=LM_RTOL)
    for a, b in zip(lm_model.leaves(host), lm_model.leaves(card)):
        b = b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.int8:
            assert int((a.int() - b.int()).abs().max()) <= 1
        elif a.is_floating_point():
            err = float((a - b).abs().max())
            assert err <= LM_RTOL * float(a.abs().max()) + LM_TRAIN_ATOL
        else:
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# sharding: the one-rank NCCL mesh
# ---------------------------------------------------------------------------
@pytest.fixture
def nccl_group():
    """A one-rank NCCL process group on the card, destroyed after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group

    dev = _cuda()
    init_process_group(dev)
    assert dist.get_backend() == "nccl"
    yield dev
    dist.destroy_process_group()


def _same_bits(a, b) -> bool:
    """Equal bit for bit (the sign of a zero too)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    a, b = a.contiguous(), b.contiguous()
    if a.is_floating_point():
        a, b = (t.view(ints[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


MOE_ARCHS = ["qwen3-moe-235b-a22b", "grok-1-314b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_moe_repeats_bitwise_with_default_algorithms(nccl_group, arch,
                                                     compute):
    """The EP (qwen3-moe) and ff (grok) layers at ``reduced()``, forward
    and backward twice each through ``_moe_local`` and through the
    sharded body under a (1, 1) mesh (real NCCL calls), with default
    algorithms: y, aux and the grads of every weight and of the input
    repeat bit for bit, and the two bodies agree bit for bit (the
    dispatch's backward and the combine sum each token's k rows in a
    fixed order; nothing accumulates with atomics)."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import mlp
    from repro_torch.sharding import specs as sh

    dev = nccl_group
    cfg = get_config(arch).reduced(capacity_factor=2.0,
                                   compute_dtype=compute)
    params, _ = mlp.init_moe(lm_common.make_generator(0, dev), cfg)
    x = torch.randn((8, 64, cfg.d_model), device=dev,
                    generator=lm_common.make_generator(1, dev)).to(
        lm_common.cdtype(cfg))
    mesh = make_smoke_mesh(1, 1, device=dev)

    def run(sharded):
        ps = {k: v.detach().requires_grad_() for k, v in params.items()}
        xx = x.detach().requires_grad_()
        if sharded:
            with sh.use_mesh(mesh, sh.Rules.make()):
                y, aux = mlp.moe_forward(ps, xx, cfg)
        else:
            y, aux = mlp._moe_local(ps, xx.reshape(-1, cfg.d_model), cfg)
            y = y.reshape(x.shape)
        g = torch.autograd.grad((y.float() ** 2).mean() + aux,
                                list(ps.values()) + [xx])
        return [y.detach(), aux.detach(), *g]

    runs = [run(False), run(False), run(True), run(True)]
    for got in runs[1:]:
        for a, b in zip(runs[0], got):
            assert torch.isfinite(b.float()).all() and _same_bits(a, b)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_repeats_bitwise(arch):
    """One train step of the reduced MoE model (bf16 compute) from one
    state, twice on the card with default algorithms: every leaf of the
    new state and every metric equal bit for bit."""
    from repro_torch.train import steps as lm_steps
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import ScheduleConfig

    dev = _cuda()
    cfg = get_config(arch).reduced(compute_dtype="bfloat16")
    ocfg = AdamWConfig(eight_bit=cfg.opt_8bit)
    scfg = ScheduleConfig(peak_lr=1e-3, warmup_steps=0)
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 65)).astype(
        np.int32)).to(dev)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    out = []
    for _ in range(2):
        st = lm_steps.init_train_state(lm_common.make_generator(0, dev),
                                       cfg, ocfg)
        st, m = lm_steps.train_step(st, batch, cfg, ocfg, scfg)
        out.append((list(lm_model.leaves(st)), m))
    (s0, m0), (s1, m1) = out
    assert all(_same_bits(m0[k], m1[k]) for k in m0)
    assert all(_same_bits(a, b) for a, b in zip(s0, s1))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_sharded_body_on_one_nccl_rank_equals_local(nccl_group, arch):
    """The EP (qwen3-moe) and ff (grok) bodies under a (1, 1) mesh, their
    collectives real NCCL calls, equal ``_moe_local`` bitwise, with
    grads, with default algorithms."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import mlp
    from repro_torch.sharding import specs as sh

    dev = nccl_group
    cfg = get_config(arch).reduced(capacity_factor=8.0)
    params, _ = mlp.init_moe(lm_common.make_generator(0, dev), cfg)
    x = torch.randn((4, 16, cfg.d_model), device=dev,
                    generator=lm_common.make_generator(1, dev))
    mesh = make_smoke_mesh(1, 1, device=dev)

    def run(sharded):
        ps = {k: v.detach().requires_grad_() for k, v in params.items()}
        if sharded:
            with sh.use_mesh(mesh, sh.Rules.make()):
                y, aux = mlp.moe_forward(ps, x, cfg)
        else:
            y, aux = mlp._moe_local(ps, x.reshape(64, -1), cfg)
            y = y.reshape(x.shape)
        g = torch.autograd.grad((y.float() ** 2).mean() + aux,
                                list(ps.values()))
        return y, aux, g

    (y0, a0, g0), (y1, a1, g1) = run(False), run(True)
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    for a, b in zip(g0, g1):
        assert torch.isfinite(b).all() and torch.equal(a, b)


def test_compressed_step_on_one_nccl_rank(nccl_group):
    """One compressed train step on a (1, 1, 1) mesh: the int8 payload
    through NCCL; the loss equals the plain mesh step's (the same forward)
    and the first moments take the synced gradient."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.sharding import specs as sh
    from repro_torch.train import steps
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import ScheduleConfig

    dev = nccl_group
    cfg = get_config("qwen1.5-32b").reduced(n_layers=2)
    ocfg, scfg = AdamWConfig(), ScheduleConfig(peak_lr=1e-3, warmup_steps=1)
    mesh = make_smoke_mesh(1, 1, pod=1, device=dev)
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 33)).astype(
        np.int32)).to(dev)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    spec = {"tokens": ("batch", None), "labels": ("batch", None)}
    out = {}
    for compress in (False, True):
        step, _, ssh, bsh = steps.jit_train_step(
            cfg, ocfg, scfg, mesh, sh.Rules.make(), batch, spec,
            compress=compress)
        st = sh.place(steps.init_train_state(
            lm_common.make_generator(0, dev), cfg, ocfg, compress=compress),
            ssh)
        st, m = step(st, sh.place(batch, bsh))
        out[compress] = float(m["loss"])
        assert torch.count_nonzero(st["opt"]["m"]["head"]) > 0
    assert np.isfinite(out[True]) and out[True] == out[False]


# ---------------------------------------------------------------------------
# the dry-run tier: fake CUDA tensors on a CUDA build
# ---------------------------------------------------------------------------
_DRYRUN_REDUCED = """
import json, sys
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.launch import dryrun, shapes

arch, shape = sys.argv[1], sys.argv[2]
configs.ARCHS[arch] = configs.ARCHS[arch].reduced()
shapes.SHAPES = dict(shapes.SHAPES, **{
    shape: base.InputShape(shape, 64, 8, shapes.SHAPES[shape].kind)})
rec = dryrun.run_cell(arch, shape, False, device="cuda", mesh_shape=(2, 2))
print(json.dumps(rec))
"""


@pytest.mark.parametrize("arch,shape", [("qwen3-moe-235b-a22b", "train_4k"),
                                        ("mamba2-780m", "decode_32k")])
def test_dryrun_of_a_reduced_cell_with_fake_cuda_tensors(arch, shape):
    """``dryrun.run_cell`` with ``device="cuda"`` for a reduced cell on a
    fake (2, 2) mesh, in a subprocess (a fake group of its own): the
    record's memory account, cost and inventory are filled, the argument
    bytes equal ``argument_bytes`` of the same cell, and the card's
    memory is untouched by the fake tensors."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    dev = _cuda()
    root = Path(__file__).resolve().parent.parent
    before = torch.cuda.memory_allocated(dev)
    r = subprocess.run([sys.executable, "-c", _DRYRUN_REDUCED, arch, shape],
                       cwd=root, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["device"] == "cuda" and rec["mesh"] == {"data": 2, "model": 2}
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert rec["peak_bytes"] == (mem["argument_size_in_bytes"]
                                 + mem["temp_size_in_bytes"])
    assert rec["cost_terms"]["total_flops"] > 0
    assert rec["cost_terms"]["direct_total_flops"] > 0
    if shape == "train_4k":  # the EP MoE's all-to-all
        assert rec["collectives_scanned"]["all-to-all"]["count"] > 0
    assert torch.cuda.memory_allocated(dev) == before
