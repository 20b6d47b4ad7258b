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


@pytest.mark.parametrize("variant", [None, "global"])
@pytest.mark.parametrize("m", ROUTE_SIZES)
def test_route_descend_matches_plain(m, variant):
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records, _ = random_case(m % 7)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    # the tree's records, repeated, past m + 1 rows
    host = np.resize(records, (m + 1, records.shape[1]))
    full = torch.from_numpy(host).to(dev)
    with trk._forced(variant):
        plan = trk.route_plan(ops)
    assert plan[0] == (2 if variant == "global" else 1)
    ops["route_plan"] = plan
    # a batch at the allocation's start, and one 4 bytes into a row
    for rec, want_host in ((full[:m], host[:m]), (full[1:], host[1:])):
        assert rec.shape[0] == m
        before = _build.launch_counts()
        got = trk.route(rec, ops)
        after = _build.launch_counts()
        assert after["route_descend"] == before["route_descend"] + (m > 0)
        torch.cuda.synchronize()
        assert torch.equal(got, trk.route_plain(rec, ops))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      frozen.route(want_host))


def test_route_descend_plan_by_shape():
    from repro_torch.kernels import _build

    def _plan(*args):
        return _build.plan("route_descend", *args)

    dev = _cuda()
    props = torch.cuda.get_device_properties(dev)
    optin = props.shared_memory_per_block_optin
    # tpch-40M's 1,447 nodes at 21 columns: nodes and 32 warps' tiles
    kernel, warps, smem, most = _plan(dev.index, 1447, 21, 0)
    assert (kernel, smem) == (1, 16 * 1447 + warps * 128 * 21)
    assert most >= props.multi_processor_count
    # nodes past what fits beside four warps' tiles: the global kernel,
    # and forcing the shared one past the card's limit raises
    too_many = (optin - 4 * 128 * 21) // 16 + 1
    assert _plan(dev.index, too_many, 21, 0)[0] == 2
    with pytest.raises(RuntimeError, match="route_descend kernel launch"):
        _plan(dev.index, optin // 16, 21, 1)


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
    assert delta == {"route_descend": 1}
    np.testing.assert_array_equal(got, frozen.route(records))


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


def _fold_both(ops, batches, variant):
    """Fold the same batches with the kernel and with the plain version;
    the block ids of each, and the two accumulators."""
    with tfk._forced(variant):
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


@pytest.mark.parametrize("variant", ["shared", "global"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fused_variants_match_plain(seed, variant):
    from repro_torch.kernels import _build

    dev = _cuda()
    frozen, records, _ = random_case(seed)
    ops = tplan.to_device(tplan.pack_route_constants(frozen), dev)
    # an unaligned batch (rows 1..) takes the 4-byte copies
    for rec in (torch.from_numpy(records).to(dev),
                torch.from_numpy(records).to(dev)[1:]):
        name = f"fused_ingest_{variant}"
        before = _build.launch_counts()[name]
        got, want, acc_k, acc_p = _fold_both(ops, [rec], variant)
        assert _build.launch_counts()[name] == before + 1
        assert torch.equal(got, want)
        _assert_same(acc_k, acc_p)


def test_shared_plan_takes_every_warp_that_fits():
    from repro_torch.kernels import _build

    def _plan(index, shape, variant):
        return _build.plan("fused_ingest", index, *shape, variant)

    dev = _cuda()
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    # (L, d, cw, aw, categorical columns, adv cuts); the first is tpch-40M's
    for shape in ((724, 21, 5, 1, 11, 3), (40, 5, 2, 1, 2, 6),
                  (900, 21, 5, 1, 11, 3)):
        L, d, cw, aw, n_cat, n_adv = shape
        fixed = 4 * L * (1 + 2 * d + cw + 2 * aw) + 4 * (n_cat + d + 3 * n_adv)
        warps = min(32, (optin - fixed) // (4 * 32 * d))
        kernel, got_warps, smem, most = _plan(dev.index, shape, 0)
        if warps < 4:
            assert kernel == 2
            continue
        assert (kernel, got_warps, smem) == (1, warps, fixed + warps * 128 * d)
        assert most >= torch.cuda.get_device_properties(dev).multi_processor_count
    if optin >= 232448:  # an H100's 227 KB: every warp fits at tpch-40M
        assert _plan(dev.index, (724, 21, 5, 1, 11, 3), 0)[1] == 32


@pytest.mark.parametrize("variant", [None, "shared", "global"])
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
    assert after["fused_ingest_global"] == before["fused_ingest_global"] + 2
    assert after["fused_ingest_shared"] == before["fused_ingest_shared"]
    assert torch.equal(got, want)
    _assert_same(acc_k, acc_p)
    # forcing the shared kernel raises: the request is refused, and
    # nothing falls back to another kernel or the plain version
    with pytest.raises(RuntimeError, match="fused_ingest kernel launch"):
        with tfk._forced("shared"):
            tfk.IngestAccumulator(ops)
    assert _build.launch_counts() == after
    # the refusal leaves no error behind for the next launch
    with tfk._forced("global"):
        acc = tfk.IngestAccumulator(ops)
    acc.fold(rec)
    torch.cuda.synchronize()


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
    assert counts["fused_ingest_shared"] + counts["fused_ingest_global"] == (
        rep.n_batches)
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
    name = tfk.KERNEL_NAMES[accs[0]._launch[0]]
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
