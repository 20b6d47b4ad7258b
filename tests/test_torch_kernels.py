"""The port's kernels against the JAX package's Pallas kernels.

Each kernel module of ``repro_torch`` holds a CUDA kernel and a plain
PyTorch version.  On the CPU the plain versions run; here they meet the
Pallas functions of ``repro`` (interpret mode) on the same trees, records
and workloads, made from a seed with numpy.  A numpy descent over the
packed nodes, which three CUDA kernels descend, meets the numpy route,
and a numpy decoding of the packed cuts, which four kernels test, meets
the Pallas predicate matrix.
Block ids, predicate matrices, per-leaf aggregates and hit matrices
compare exactly; the
Pallas per-conjunct scanned sum is float32, so it is held at rtol=1e-6
(as ``tests/test_kernels.py`` holds it).  The CUDA kernels themselves
are held to their plain versions in ``test_torch_gpu.py``.
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import query as qry  # noqa: E402
from repro.engine import plan as rplan  # noqa: E402
from repro.kernels import fused_ingest as rfk  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import route_records as rrk  # noqa: E402
from repro_torch.core import predicates as tpreds  # noqa: E402
from repro_torch.core import query as tqry  # noqa: E402
from repro_torch.core.qdtree import singleton_tree  # noqa: E402
from repro_torch.core.routing import cut_table_arrays  # noqa: E402
from repro_torch.core.qdtree import FrozenQdTree as TorchTree  # noqa: E402
from repro_torch.engine import plan as tplan  # noqa: E402
from repro_torch.kernels import fused_ingest as tfk  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import query_intersect as tqk  # noqa: E402
from repro_torch.kernels import route_records as trk  # noqa: E402
from tests.test_qdtree import random_tree, small_setup  # noqa: E402
from tests.test_query import random_query  # noqa: E402

TILE_M = 256
SEEDS = [0, 1, 7]


def carry_tree(tree) -> TorchTree:
    """A JAX-package tree in the port, through its ``.npz``."""
    buf = io.BytesIO()
    tree.save(buf)
    buf.seek(0)
    return TorchTree.load(buf)


def carry_wt(wt: qry.WorkloadTensors) -> tqry.WorkloadTensors:
    """JAX-package workload tensors in the port, as their arrays."""
    return tqry.WorkloadTensors(
        q_lo=wt.q_lo.copy(), q_hi=wt.q_hi.copy(), q_cat=wt.q_cat.copy(),
        q_adv=wt.q_adv.copy(), conj_query=wt.conj_query.copy(),
        n_queries=wt.n_queries,
    )


def setup_case(seed, m=None):
    """Random tree with range, IN and advanced cuts, and a ragged batch."""
    schema, records, cuts = small_setup(seed, m=600)
    rng = np.random.default_rng(seed)
    frozen = random_tree(schema, cuts, records, rng, max_splits=12).freeze()
    m = m or int(rng.integers(300, 600))  # not a multiple of TILE_M
    return frozen, records[:m]


def pallas_operands(frozen, records):
    """The Pallas route operands, with the batch padded to TILE_M rows."""
    cb = rplan.pad_bucket(frozen.cuts.n_cuts, rplan.LANE)
    lb = rplan.pad_bucket(frozen.n_leaves, rplan.LANE)
    k = rplan.pack_route_constants(frozen, cb, lb)
    m = records.shape[0]
    mp = -(-m // TILE_M) * TILE_M
    padded = np.zeros((mp, records.shape[1]), np.float32)
    padded[:m] = records
    valid = np.zeros((mp, 1), np.float32)
    valid[:m] = 1.0
    return k, jnp.asarray(padded), jnp.asarray(valid)


def port_operands(frozen):
    return tplan.to_device(tplan.pack_route_constants(carry_tree(frozen)),
                           "cpu")


def pallas_eval_cuts(k, rec):
    return np.asarray(rrk.eval_cuts_pallas(
        rec, *(jnp.asarray(k[n]) for n in (
            "dim_onehot", "cutpoint", "in_mask_t", "is_cat", "cat_off",
            "adv_cols", "adv_sel", "kind",
        )),
        tile_m=TILE_M, n_cat_bits=k["n_cat_bits"], n_adv=k["n_adv"],
        interpret=True,
    ))


@pytest.mark.parametrize("seed", SEEDS)
def test_eval_cuts_plain_matches_pallas(seed):
    frozen, records = setup_case(seed)
    k, rec, _ = pallas_operands(frozen, records)
    want = pallas_eval_cuts(k, rec)
    got = trk.eval_cuts_plain(torch.from_numpy(records), port_operands(frozen))
    m, c = got.shape
    assert (m, c) == (records.shape[0], frozen.cuts.n_cuts)
    np.testing.assert_array_equal(got.numpy(), want[:m, :c].astype(np.uint8))


def pallas_locate_leaf(k, m_mat):
    return np.asarray(rrk.locate_leaf_pallas(
        jnp.asarray(m_mat), jnp.asarray(k["pathpos"]),
        jnp.asarray(k["pathneg"]), jnp.asarray(k["leafid"]),
        tile_m=TILE_M, tile_l=rplan.LANE, interpret=True,
    ))


@pytest.mark.parametrize("seed", SEEDS)
def test_locate_leaf_plain_matches_pallas(seed):
    frozen, records = setup_case(seed)
    k, rec, _ = pallas_operands(frozen, records)
    m_mat = pallas_eval_cuts(k, rec)
    want = pallas_locate_leaf(k, m_mat)
    ops = port_operands(frozen)
    m = records.shape[0]
    got = trk.locate_leaf_plain(
        torch.from_numpy(m_mat[:m, :frozen.cuts.n_cuts].astype(np.uint8)),
        ops,
    )
    np.testing.assert_array_equal(got.numpy(), want[:m].astype(np.int32))
    np.testing.assert_array_equal(got.numpy(), frozen.route(records))


def packed_descent(nodes, in_mask, records, depth):
    """Block ids by a numpy descent over ``plan.pack_nodes``, decoding
    ``meta`` and ``w`` as its docstring states."""
    meta = nodes[:, 0].view(np.uint32).astype(np.int64)
    left, right = nodes[:, 1].astype(np.int64), nodes[:, 2].astype(np.int64)
    w = nodes[:, 3].astype(np.int64)
    kind, col = meta >> 30, meta & 0xFFF
    off, col_b, op = (meta >> 12) & 0x3FFFF, (meta >> 12) & 0xFFF, meta >> 24
    bits = in_mask.shape[1]
    flat = np.append(in_mask.reshape(-1), 0)  # non-IN nodes read the pad
    rec = records.astype(np.int64)
    rows = np.arange(rec.shape[0])
    cur = np.zeros(rec.shape[0], np.int64)
    for _ in range(depth):
        k, v = kind[cur], rec[rows, col[cur]]
        # col_b and op are fields of advanced nodes only
        vb = rec[rows, np.where(k == 2, col_b[cur], 0)]
        o = np.where(k == 2, op[cur] & 0x3F, 0)
        pos = np.clip(v + off[cur], 0, bits - 1)
        in_set = flat[np.where(k == 1, w[cur] + pos, -1)] != 0
        adv = np.select([o == 0, o == 1, o == 2, o == 3, o == 4],
                        [v < vb, v <= vb, v > vb, v >= vb, v == vb], v != vb)
        go_left = np.select([k == 0, k == 1], [v < w[cur], in_set], adv)
        cur = np.where(right[cur] >= 0,
                       np.where(go_left, left[cur], right[cur]), cur)
    assert (right[cur] == -1).all(), "a record did not reach a leaf"
    return left[cur].astype(np.int32)


def assert_packed_descent_routes(frozen, records):
    ops = tplan.pack_route_constants(carry_tree(frozen))
    got = packed_descent(ops["nodes"], ops["in_mask"], records, ops["depth"])
    np.testing.assert_array_equal(got, frozen.route(records))


@pytest.mark.parametrize("seed", SEEDS)
def test_packed_node_descent_matches_numpy_route(seed):
    frozen, records = setup_case(seed)
    kinds = set(frozen.cuts.kind[frozen.cut_id[frozen.cut_id >= 0]].tolist())
    assert len(kinds) >= 2, "the tree should descend more than one cut kind"
    assert_packed_descent_routes(frozen, records)


def test_packed_node_descent_matches_numpy_route_on_tpch(tpch_tree,
                                                         tpch_small):
    frozen, bids = tpch_tree
    records = tpch_small[1]
    assert_packed_descent_routes(frozen, records)
    np.testing.assert_array_equal(frozen.route(records), bids)


def packed_eval(cut_pack, in_mask, records):
    """The (m, n_cuts) predicate matrix by a numpy decoding of
    ``plan.pack_cuts``'s ``(meta, w)``, as its docstring states."""
    meta = cut_pack[:, 0].view(np.uint32).astype(np.int64)
    w = cut_pack[:, 1].astype(np.int64)
    kind, col = meta >> 30, meta & 0xFFF
    off, col_b, op = (meta >> 12) & 0x3FFFF, (meta >> 12) & 0xFFF, meta >> 24
    bits = in_mask.shape[1]
    flat = np.append(in_mask.reshape(-1), 0)  # non-IN cuts read the pad
    rec = records.astype(np.int64)
    v = rec[:, col]
    vb = rec[:, np.where(kind == 2, col_b, 0)]  # col_b: advanced cuts only
    o = np.where(kind == 2, op & 0x3F, 0)
    pos = np.clip(v + off, 0, bits - 1)
    in_set = flat[np.where(kind == 1, w + pos, -1)] != 0
    adv = np.select([o == 0, o == 1, o == 2, o == 3, o == 4],
                    [v < vb, v <= vb, v > vb, v >= vb, v == vb], v != vb)
    return np.select([kind == 0, kind == 1], [v < w, in_set], adv)


def assert_packed_cuts_evaluate(frozen, records):
    k, rec, _ = pallas_operands(frozen, records)
    want = pallas_eval_cuts(k, rec)
    m, c = records.shape[0], frozen.cuts.n_cuts
    ops = tplan.pack_cut_table(carry_tree(frozen).cuts)
    assert ops["cut_pack"].shape == (c, 2)
    assert ops["cut_pack"].dtype == np.int32
    got = packed_eval(ops["cut_pack"], ops["in_mask"], records)
    np.testing.assert_array_equal(got, want[:m, :c] != 0)
    np.testing.assert_array_equal(got, tpreds.eval_cuts(records,
                                                        frozen.cuts))


@pytest.mark.parametrize("seed", SEEDS)
def test_packed_cuts_evaluate_as_pallas(seed):
    frozen, records = setup_case(seed)
    kinds = set(frozen.cuts.kind.tolist())
    assert kinds == {0, 1, 2}, "the table should hold every cut kind"
    assert_packed_cuts_evaluate(frozen, records)


def test_packed_cuts_evaluate_as_pallas_on_tpch(tpch_tree, tpch_small):
    frozen, _ = tpch_tree
    assert_packed_cuts_evaluate(frozen, tpch_small[1][:2000])


def pack_nodes_before(tree):
    """``plan.pack_nodes`` as it was before it was built on ``pack_cuts``:
    each internal node's cut packed from the cut table's arrays."""
    cuts = tree.cuts
    ca = cut_table_arrays(cuts)
    bits = int(ca["in_mask"].shape[1])
    c = tree.cut_id.astype(np.int64)
    internal = c >= 0
    cc = np.where(internal, c, cuts.n_cuts)  # leaves read a dummy cut

    def per_cut(a):
        return np.append(np.asarray(a, np.int64), 0)[cc]

    kind, dim = per_cut(ca["kind"]), per_cut(ca["dim"])
    adv = np.concatenate([ca["adv"].astype(np.int64),
                          np.zeros((1, 3), np.int64)])
    a = adv[np.where(kind == 2, per_cut(ca["adv_id"]), -1)]
    col_a, op, col_b = a[:, 0], a[:, 1], a[:, 2]
    off = ca["cat_off"].astype(np.int64)[dim]
    meta = np.select(
        [kind == 0, kind == 2],
        [dim, 2 << 30 | op << 24 | col_b << 12 | col_a],
        1 << 30 | off << 12 | dim,
    )
    w = np.where(kind == 0, per_cut(ca["cutpoint"]),
                 np.where(kind == 2, 0, cc * bits))
    out = np.stack([
        np.where(internal, meta, 0),
        np.where(internal, tree.left, tree.leaf_bid),
        np.where(internal, tree.right, -1),
        np.where(internal, w, 0),
    ], axis=1)
    return np.ascontiguousarray(out.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("seed", SEEDS + ["tpch"])
def test_pack_nodes_on_pack_cuts_is_byte_equal(seed, request):
    if seed == "tpch":
        frozen = request.getfixturevalue("tpch_tree")[0]
    else:
        frozen = setup_case(seed)[0]
    tree = carry_tree(frozen)
    got = tplan.pack_nodes(tree)
    want = pack_nodes_before(tree)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    internal = tree.cut_id >= 0
    np.testing.assert_array_equal(
        got[internal][:, [0, 3]],
        tplan.pack_cuts(tree.cuts)[tree.cut_id[internal]])


def _overflow_cuts(field):
    if field == "column":  # a range cut on column 4096
        cols = [tpreds.Column(f"x{j}", "numeric", 10) for j in range(4097)]
        b = tpreds.CutTableBuilder(tpreds.Schema(tuple(cols)))
        b.add_range(4096, tpreds.OP_LT, 5)
    elif field == "bit offset":  # an IN cut 2**18 bits in
        b = tpreds.CutTableBuilder(tpreds.Schema((
            tpreds.Column("wide", "categorical", 1 << 18),
            tpreds.Column("c", "categorical", 3),
        )))
        b.add_in(1, [1])
    else:  # an advanced cut whose col_b is 4096
        cols = [tpreds.Column(f"x{j}", "numeric", 10) for j in range(4097)]
        b = tpreds.CutTableBuilder(tpreds.Schema(tuple(cols)))
        b.add_adv(0, tpreds.OP_LT, 4096)
    return b.build()


@pytest.mark.parametrize("field", ["column", "bit offset", "col_b"])
def test_pack_cuts_raises_on_field_overflow(field):
    cuts = _overflow_cuts(field)
    assert cuts.n_cuts == 1
    with pytest.raises(ValueError, match="does not fit"):
        tplan.pack_cuts(cuts)
    with pytest.raises(ValueError, match="does not fit"):
        tplan.pack_route_constants(
            singleton_tree(cuts.schema, cuts, np.arange(1)).freeze())


def pallas_route(frozen, records):
    """The reference's route: eval_cuts_pallas, then locate_leaf_pallas."""
    k, rec, _ = pallas_operands(frozen, records)
    bids = pallas_locate_leaf(k, pallas_eval_cuts(k, rec))
    return bids[:records.shape[0]].astype(np.int32)


def assert_route_matches_pallas(frozen, records):
    got = trk.route(torch.from_numpy(records), port_operands(frozen))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), pallas_route(frozen, records))
    np.testing.assert_array_equal(got.numpy(), frozen.route(records))


@pytest.mark.parametrize("seed", SEEDS)
def test_route_plain_matches_pallas(seed):
    frozen, records = setup_case(seed)
    assert_route_matches_pallas(frozen, records)


def test_route_plain_matches_pallas_on_tpch(tpch_tree, tpch_small):
    frozen, _ = tpch_tree
    assert_route_matches_pallas(frozen, tpch_small[1])


def test_cpu_engine_route_goes_through_route(monkeypatch):
    from repro_torch.engine import LayoutEngine

    frozen, records = setup_case(0)
    calls = []
    real = trk.route

    def counting(rec, ops):
        calls.append(rec.shape[0])
        return real(rec, ops)

    def refuse(*args):
        raise AssertionError("route should not call the two-kernel form")

    monkeypatch.setattr(trk, "route", counting)
    monkeypatch.setattr(trk, "eval_cuts", refuse)
    monkeypatch.setattr(trk, "locate_leaf", refuse)
    eng = LayoutEngine(carry_tree(frozen), device="cpu")
    np.testing.assert_array_equal(eng.route(records), frozen.route(records))
    assert calls == [records.shape[0]]


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_ingest_plain_matches_pallas(seed):
    frozen, records = setup_case(seed)
    k, rec, valid = pallas_operands(frozen, records)
    bids, counts, lo, hi, cat, advt, advf = (np.asarray(x) for x in (
        rfk.fused_ingest_pallas(
            rec, valid, *(jnp.asarray(k[n]) for n in (
                "dim_onehot", "cutpoint", "in_mask_t", "is_cat", "cat_off",
                "adv_cols", "adv_sel", "kind", "pathpos", "pathneg",
                "leafid",
            )),
            tile_m=TILE_M, tile_l=rplan.LANE, n_cat_bits=k["n_cat_bits"],
            n_adv=k["n_adv"], interpret=True,
        )
    ))
    acc = tfk.IngestAccumulator(port_operands(frozen))
    got_bids = tfk.fused_ingest_plain(torch.from_numpy(records), acc)
    m, L = records.shape[0], frozen.n_leaves
    bits, na = frozen.leaf_cat.shape[1], frozen.cuts.n_adv
    np.testing.assert_array_equal(got_bids.numpy(), bids[:m, 0] - 1)
    np.testing.assert_array_equal(acc.counts.numpy(), counts[0, :L])
    ne = counts[0, :L] > 0
    # occupied leaves carry the same bounds; empty ones each side's identity
    np.testing.assert_array_equal(acc.lo.numpy()[ne], lo[:L][ne])
    np.testing.assert_array_equal(acc.hi.numpy()[ne], hi[:L][ne])
    assert (acc.lo.numpy()[~ne] == tfk.I32_MAX).all()
    assert (acc.hi.numpy()[~ne] == tfk.I32_MIN).all()
    # packed bits, unpacked, are the kernel's flags
    np.testing.assert_array_equal(
        tops.unpack_words(acc.cat.numpy(), bits), cat[:L, :bits] != 0
    )
    np.testing.assert_array_equal(
        tops.unpack_words(acc.advt.numpy(), na), advt[:L, :na] != 0
    )
    np.testing.assert_array_equal(
        tops.unpack_words(acc.advf.numpy(), na), advf[:L, :na] != 0
    )


def uneven_batches(records, n_batches, rng):
    """``n_batches`` slices of uneven sizes; with more than one, one of
    them is a single row."""
    m = records.shape[0]
    if n_batches == 1:
        return [records]
    cuts = np.sort(rng.choice(np.arange(2, m - 1), n_batches - 2,
                              replace=False))
    single = int(rng.integers(0, n_batches))
    sizes = np.diff(np.concatenate([[0], cuts, [m - 1]])).tolist()
    sizes.insert(single, 1)
    return np.split(records, np.cumsum(sizes)[:-1])


@pytest.mark.parametrize("n_batches", [1, 3, 7])
@pytest.mark.parametrize("seed", SEEDS)
def test_running_accumulator_matches_fused_ingest_ref(seed, n_batches):
    from repro.kernels.ref import fused_ingest_ref

    frozen, records = setup_case(seed)
    batches = uneven_batches(records, n_batches, np.random.default_rng(seed))
    assert len(batches) == n_batches and sum(map(len, batches)) == len(
        records
    )
    if n_batches > 1:
        assert min(map(len, batches)) == 1
    tree = carry_tree(frozen)
    acc = tfk.IngestAccumulator(port_operands(frozen))
    bids = [acc.fold(torch.from_numpy(b), bids=True).numpy() for b in batches]
    want_bids, want = fused_ingest_ref(frozen, records)
    np.testing.assert_array_equal(np.concatenate(bids), want_bids)
    got = acc.partial(tree)
    for f in ("counts", "lo", "hi", "cat", "adv"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


def _query_case(seed):
    schema, records, cuts = small_setup(seed)
    rng = np.random.default_rng(seed)
    frozen = random_tree(schema, cuts, records, rng).freeze()
    bids = frozen.route(records)
    frozen.tighten(records, bids)
    work = qry.Workload(
        schema, tuple(random_query(schema, rng) for _ in range(9))
    )
    sizes = np.bincount(bids, minlength=frozen.n_leaves)
    return frozen, work.tensorize(cuts), sizes


@pytest.mark.parametrize("seed", SEEDS)
def test_query_intersect_plain_matches_pallas(seed):
    frozen, wt, sizes = _query_case(seed)
    want_hits, want_scanned = rops.query_intersect(
        frozen, wt, block_sizes=sizes, interpret=True
    )
    got_hits, got_scanned = tops.query_intersect(
        carry_tree(frozen), carry_wt(wt), block_sizes=sizes, device="cpu"
    )
    np.testing.assert_array_equal(got_hits, want_hits)
    assert got_scanned.dtype == np.int64
    np.testing.assert_allclose(got_scanned, want_scanned, rtol=1e-6)
    # the conjunct-level hit matrix is the numpy oracle's, exactly
    conj = qry.conjuncts_intersect(
        frozen.leaf_lo, frozen.leaf_hi, frozen.leaf_cat, frozen.leaf_adv,
        wt, frozen.schema,
    )
    tree = carry_tree(frozen)
    tree.block_sizes = sizes
    layout = tops.query_layout(tree.schema, frozen.cuts.n_adv)
    hits, scanned = tqk.query_intersect_plain(
        tplan.to_device(tplan.pack_leaf_descs(tree, layout), "cpu"),
        tplan.to_device(tops.pack_workload(carry_wt(wt), layout), "cpu"),
        tplan.to_device(layout, "cpu"),
    )
    np.testing.assert_array_equal(hits.numpy().astype(bool), conj)
    np.testing.assert_array_equal(
        scanned.numpy(), (conj * sizes[:, None]).sum(axis=0)
    )


def _tpch_query_case(tpch_tree, tpch_small):
    """The greedy TPC-H-like tree: 146 categorical bits in segments that
    straddle 32-bit words, and the fixture's workload."""
    frozen, bids = tpch_tree
    _, _, work, cuts = tpch_small
    sizes = np.bincount(bids, minlength=frozen.n_leaves)
    return frozen, work.tensorize(cuts), sizes


@pytest.mark.parametrize("sizes_scale", [1, 2**33])
def test_packed_query_intersect_plain_matches_pallas_on_tpch(
    tpch_tree, tpch_small, sizes_scale
):
    frozen, wt, sizes = _tpch_query_case(tpch_tree, tpch_small)
    layout = tops.query_layout(frozen.schema, frozen.cuts.n_adv)
    assert any(
        layout["seg_word"][s] != layout["seg_word"][e - 1]
        for s, e in layout["seg_ranges"]
    ), "some segment should straddle a word boundary"
    want_hits, _ = rops.query_intersect(
        frozen, wt, block_sizes=sizes, interpret=True
    )
    conj = qry.conjuncts_intersect(
        frozen.leaf_lo, frozen.leaf_hi, frozen.leaf_cat, frozen.leaf_adv,
        wt, frozen.schema,
    )
    tree = carry_tree(frozen)
    # block sizes past 2**24 (and 2**32): scanned is exact int64
    tree.block_sizes = sizes.astype(np.int64) * sizes_scale + 1
    hits, scanned = tqk.query_intersect_plain(
        tplan.to_device(tplan.pack_leaf_descs(tree, layout), "cpu"),
        tplan.to_device(tops.pack_workload(carry_wt(wt), layout), "cpu"),
        tplan.to_device(layout, "cpu"),
    )
    np.testing.assert_array_equal(hits.numpy().astype(bool), conj)
    np.testing.assert_array_equal(
        tqry.queries_intersect(hits.numpy().astype(bool), carry_wt(wt)),
        want_hits,
    )
    assert scanned.dtype == torch.int64
    want = (conj.astype(np.int64) * tree.block_sizes[:, None]).sum(axis=0)
    np.testing.assert_array_equal(scanned.numpy(), want)
