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


def _next_node(nd, cur, rec, rows, flat, bits):
    """Each row's next node from its current node ``cur``, whose packed row
    (``plan.pack_nodes``) is ``nd``, decoding ``meta`` and ``w`` as its
    docstring states; a leaf is its own next node."""
    meta = nd[:, 0].view(np.uint32).astype(np.int64)
    left, right = nd[:, 1].astype(np.int64), nd[:, 2].astype(np.int64)
    w = nd[:, 3].astype(np.int64)
    kind, col = meta >> 30, meta & 0xFFF
    off, col_b, op = (meta >> 12) & 0x3FFFF, (meta >> 12) & 0xFFF, meta >> 24
    v = rec[rows, col]
    # col_b and op are fields of advanced nodes only
    vb = rec[rows, np.where(kind == 2, col_b, 0)]
    o = np.where(kind == 2, op & 0x3F, 0)
    pos = np.clip(v + off, 0, bits - 1)
    in_set = flat[np.where(kind == 1, w + pos, -1)] != 0
    adv = np.select([o == 0, o == 1, o == 2, o == 3, o == 4],
                    [v < vb, v <= vb, v > vb, v >= vb, v == vb], v != vb)
    go_left = np.select([kind == 0, kind == 1], [v < w, in_set], adv)
    return np.where(right >= 0, np.where(go_left, left, right), cur)


def packed_descent(nodes, in_mask, records, depth):
    """Block ids by a numpy descent over ``plan.pack_nodes``."""
    flat = np.append(in_mask.reshape(-1), 0)  # non-IN nodes read the pad
    rec = records.astype(np.int64)
    rows = np.arange(rec.shape[0])
    cur = np.zeros(rec.shape[0], np.int64)
    for _ in range(depth):
        cur = _next_node(nodes[cur], cur, rec, rows, flat, in_mask.shape[1])
    assert (nodes[cur, 2] == -1).all(), "a record did not reach a leaf"
    return nodes[cur, 1].astype(np.int32)


def packed_descent_prefix(nodes, in_mask, records, depth, k):
    """:func:`packed_descent` as ``csrc/descend.cuh::descend_prefix`` walks
    it: the first ``k`` nodes from a staged copy while the path stays in
    them, then the rest from the node array, whose first ``k`` rows are
    overwritten here by a leaf of block -7, so a path that came back into
    the prefix would end there."""
    staged = nodes[:k].copy()
    deep = nodes.copy()
    deep[:k] = (0, -7, -1, 0)
    flat = np.append(in_mask.reshape(-1), 0)
    rec = records.astype(np.int64)
    rows = np.arange(rec.shape[0])
    cur = np.zeros(rec.shape[0], np.int64)
    out = np.zeros(rec.shape[0], bool)  # the path has left the prefix

    def node():
        return np.where(out[:, None], deep[cur], staged[np.minimum(cur, k - 1)])

    for _ in range(depth):
        cur = _next_node(node(), cur, rec, rows, flat, in_mask.shape[1])
        out |= cur >= k
    nd = node()
    assert (nd[:, 2] == -1).all(), "a record did not reach a leaf"
    return nd[:, 1].astype(np.int32)


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


def node_levels(tree) -> np.ndarray:
    """(n_nodes,) each node's level, the root's 0."""
    level = np.zeros(tree.n_nodes, np.int64)
    for node in range(tree.n_nodes):  # BFS order: parents come first
        if tree.cut_id[node] >= 0:
            level[tree.left[node]] = level[tree.right[node]] = level[node] + 1
    return level


def grown_port_tree(n_leaves):
    """The port's ``random_layout`` over a TPC-H-like sample (four rows a
    leaf) and the tpch workload's cuts, and 2,000 other records."""
    from repro_torch.core.qdtree import random_layout
    from repro_torch.data.datagen import make_tpch_like
    from repro_torch.data.workload import make_tpch_workload

    schema, sample = make_tpch_like(4 * n_leaves, seed=0)
    work, _ = make_tpch_workload(schema, n_per_template=10, seed=0)
    tree = random_layout(work.candidate_cuts(), sample, n_leaves, 0)
    return tree, make_tpch_like(2000, seed=1)[1]


# ≈ 1 s for the tree of 2,000 leaves on a CPU of this suite's
@pytest.mark.parametrize("case", [1, 50, 724, 2000, "tpch"])
def test_pack_nodes_puts_children_after_their_parent(case, request):
    """``pack_nodes`` keeps ``freeze``'s BFS order: every child's index is
    greater than its parent's, which ``route_descend_prefix``'s two-loop
    descent rests on (a path that leaves the BFS prefix never returns)."""
    if case == "tpch":
        tree = carry_tree(request.getfixturevalue("tpch_tree")[0])
    else:
        tree = grown_port_tree(case)[0]
        assert tree.n_leaves == case
    nodes = tplan.pack_nodes(tree)
    parent = np.flatnonzero(nodes[:, 2] >= 0)
    assert parent.size == tree.n_leaves - 1
    assert (nodes[parent, 1] > parent).all()
    assert (nodes[parent, 2] > parent).all()
    # each node but the root is one parent's child
    children = np.sort(np.concatenate([nodes[parent, 1], nodes[parent, 2]]))
    np.testing.assert_array_equal(children, np.arange(1, tree.n_nodes))


@pytest.mark.parametrize("case", SEEDS + ["tpch", "grown"])
def test_prefix_descent_matches_numpy_route(case, request):
    """The descent split at a prefix of K nodes (the root alone, a K that
    ends in the middle of a level, every node) equals the numpy route and
    the descent over one node array."""
    if case == "tpch":
        frozen, records = (request.getfixturevalue("tpch_tree")[0],
                           request.getfixturevalue("tpch_small")[1])
        tree = carry_tree(frozen)
    elif case == "grown":
        tree, records = grown_port_tree(2000)
        frozen = tree
    else:
        frozen, records = setup_case(case)
        tree = carry_tree(frozen)
    ops = tplan.pack_route_constants(tree)
    nodes, in_mask, depth = ops["nodes"], ops["in_mask"], ops["depth"]
    want = frozen.route(records)
    np.testing.assert_array_equal(
        packed_descent(nodes, in_mask, records, depth), want)
    level = node_levels(tree)
    mid = int(np.searchsorted(level, depth // 2))  # first node of that level
    mid += int((level == depth // 2).sum()) // 2  # ... and half of it
    assert 1 < mid < tree.n_nodes
    for k in (1, mid, tree.n_nodes):
        np.testing.assert_array_equal(
            packed_descent_prefix(nodes, in_mask, records, depth, k), want)


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


def grown_tpch_case(n_leaves, m, seed=0):
    """A JAX-package tree of ``n_leaves`` leaves over the TPC-H-like schema
    and the tpch workload's cuts (tpch-40M's), grown by random legal
    splits of a sample, and ``m`` other records."""
    from repro.core import predicates as rpreds
    from repro.core.qdtree import singleton_tree as r_singleton
    from repro.data import datagen as rdatagen
    from repro.data import workload as rwl
    from repro_torch.core.qdtree import grow_random

    schema, sample = rdatagen.make_tpch_like(4 * n_leaves, seed=seed)
    work, _ = rwl.make_tpch_workload(schema, n_per_template=10, seed=seed)
    cuts = work.candidate_cuts()
    tree = r_singleton(schema, cuts, np.arange(sample.shape[0]))
    frozen = grow_random(tree, rpreds.eval_cuts(sample, cuts), n_leaves,
                         seed)
    assert frozen.n_leaves == n_leaves
    return frozen, rdatagen.make_tpch_like(m, seed=seed + 1)[1]


@pytest.fixture(scope="module")
def tpch_1300():
    return grown_tpch_case(1300, 3000)


# ≈ 4 s (1,300 leaves, the tree's growth included) and 4 s (8,000) on a
# CPU of this suite's
@pytest.mark.parametrize("n_leaves", [1300, 8000])
def test_fused_ingest_plain_matches_ref_past_one_block(n_leaves, tpch_1300):
    """Trees whose aggregates do not fit one block (the cluster or the
    global kernel's, on the card): the plain version equals ``repro``'s
    numpy oracle."""
    from repro.kernels.ref import fused_ingest_ref

    frozen, records = (tpch_1300 if n_leaves == 1300
                       else grown_tpch_case(n_leaves, 3000))
    shape = tfk.plan_shape(port_operands(frozen))
    assert shape[0] == n_leaves and tfk.shared_warps_fit(shape, OPTIN) < 4
    acc = tfk.IngestAccumulator(port_operands(frozen))
    bids = tfk.fused_ingest_plain(torch.from_numpy(records), acc)
    want_bids, want = fused_ingest_ref(frozen, records)
    np.testing.assert_array_equal(bids.numpy(), want_bids)
    got = acc.partial(carry_tree(frozen))
    for f in ("counts", "lo", "hi", "cat", "adv"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_fused_ingest_plain_matches_pallas_past_one_block(tpch_1300):
    """The Pallas kernel (interpret mode) on 1,300 leaves, ≈ 2 s."""
    frozen, records = tpch_1300
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
    np.testing.assert_array_equal(acc.lo.numpy()[ne], lo[:L][ne])
    np.testing.assert_array_equal(acc.hi.numpy()[ne], hi[:L][ne])
    np.testing.assert_array_equal(
        tops.unpack_words(acc.cat.numpy(), bits), cat[:L, :bits] != 0)
    np.testing.assert_array_equal(
        tops.unpack_words(acc.advt.numpy(), na), advt[:L, :na] != 0)
    np.testing.assert_array_equal(
        tops.unpack_words(acc.advf.numpy(), na), advf[:L, :na] != 0)


# -- the leafwise design's stages (csrc/fused_ingest.cu), modelled in numpy --
def leafwise_sort(ids, n_leaves):
    """Stages 1-3: each leaf's count (the histogram) and each row's slot
    among its leaf's rows (here in row order, one of the orders the
    kernels' atomics may give), the counts' exclusive scan (each leaf's
    first slot; the last entry is the rows), and the scatter of each row to
    its leaf's first slot plus its own."""
    m = ids.shape[0]
    hist = np.bincount(ids, minlength=n_leaves)
    offsets = np.zeros(n_leaves + 1, np.int64)
    offsets[1:] = np.cumsum(hist)
    by_leaf = np.argsort(ids, kind="stable")
    slots = np.empty(m, np.int64)
    slots[by_leaf] = np.arange(m) - offsets[ids[by_leaf]]
    order = np.empty(m, np.int64)
    order[offsets[ids] + slots] = np.arange(m)
    return hist, offsets, order


def leafwise_fold_model(records, ops, acc, chunk):
    """The design's four stages over one batch, folded into the running
    accumulator ``acc`` (a CPU ``IngestAccumulator``, its fields as numpy
    views): route, sort, then chunks of at most ``chunk`` rows of one leaf
    (the leaf order cut at every multiple of ``chunk`` and every leaf
    boundary), each chunk's count, min, max, categorical and advanced-cut
    bits, merged into the running words.  Returns the block ids."""
    ids = trk.route_plain(torch.from_numpy(records), ops).numpy()
    L = acc.lo.shape[0]
    hist, _, order = leafwise_sort(ids, L)
    counts, lo, hi = (acc.counts.numpy(), acc.lo.numpy(), acc.hi.numpy())
    cat, advt, advf = (t.numpy().view(np.uint32)
                       for t in (acc.cat, acc.advt, acc.advf))
    counts += hist
    leaf_of = ids[order]
    m = ids.shape[0]
    cuts = np.flatnonzero((np.arange(m) % chunk == 0)
                          | np.r_[True, leaf_of[1:] != leaf_of[:-1]])
    cat_dims = ops["cat_dims"].numpy()
    cat_off = ops["cat_off"].numpy()
    bits = int(ops["bits"])
    adv = ops["adv"].numpy()[:int(ops["n_adv"])]
    for s, e in zip(cuts, np.r_[cuts[1:], m]):
        rows, leaf = records[order[s:e]], leaf_of[s]
        assert e - s <= chunk and (leaf_of[s:e] == leaf).all()
        lo[leaf] = np.minimum(lo[leaf], rows.min(axis=0))
        hi[leaf] = np.maximum(hi[leaf], rows.max(axis=0))
        pos = np.clip(rows[:, cat_dims] + cat_off[cat_dims], 0, bits - 1)
        words = np.zeros(cat.shape[1], np.uint32)
        np.bitwise_or.at(words, pos >> 5, np.uint32(1) << (pos & 31).astype(
            np.uint32))
        cat[leaf] |= words
        for a, (ca, op, cb) in enumerate(adv):
            va, vb = rows[:, ca], rows[:, cb]
            truth = [va < vb, va <= vb, va > vb, va >= vb,
                     va == vb][op] if op < 5 else va != vb
            bit = np.uint32(1 << (a & 31))
            if truth.any():
                advt[leaf, a >> 5] |= bit
            if not truth.all():
                advf[leaf, a >> 5] |= bit
    return ids


@pytest.fixture(scope="module")
def tpch_1800():
    return grown_tpch_case(1800, 3000)


@pytest.fixture(scope="module")
def tpch_8000():
    return grown_tpch_case(8000, 3000)


def leafwise_case(case, tpch_1800, tpch_8000):
    """A grown tree and a batch: 1,800 or 8,000 leaves, or 1,800 leaves
    with every row of the batch in one leaf (the busiest's rows repeated)."""
    if case == "8000":
        return tpch_8000
    frozen, records = tpch_1800
    if case == "one_leaf":
        ids = frozen.route(records)
        records = np.resize(records[ids == np.bincount(ids).argmax()],
                            records.shape)
        assert np.unique(frozen.route(records)).size == 1
    return frozen, records


# chunks of one row, of a prime count, of csrc/fused_ingest.cu's kChunk
# and longer than most leaves' runs; ≈ 1 s a case once the trees are grown
# (≈ 1 s and 4 s, once a module)
LEAFWISE_MODEL_CHUNKS = [1, 7, 64, 4096]


@pytest.mark.parametrize("chunk", LEAFWISE_MODEL_CHUNKS)
@pytest.mark.parametrize("case", ["1800", "8000", "one_leaf"])
def test_leafwise_model_matches_plain_and_ref(case, chunk, tpch_1800,
                                              tpch_8000):
    """The leafwise design's stages, modelled, fold two batches into one
    running accumulator exactly as the plain version does, and as the
    reference's numpy oracle does over their concatenation."""
    from repro.kernels.ref import fused_ingest_ref

    frozen, records = leafwise_case(case, tpch_1800, tpch_8000)
    ops = port_operands(frozen)
    acc_m, acc_p = (tfk.IngestAccumulator(ops) for _ in range(2))
    halves = (records[:1234], records[1234:])
    got = [leafwise_fold_model(h, ops, acc_m, chunk) for h in halves]
    want = [tfk.fused_ingest_plain(torch.from_numpy(h), acc_p).numpy()
            for h in halves]
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    for name, a, b in zip(acc_m.FIELDS, acc_m.tensors(), acc_p.tensors()):
        assert torch.equal(a, b), name
    want_bids, want_part = fused_ingest_ref(frozen, records)
    np.testing.assert_array_equal(np.concatenate(got), want_bids)
    part = acc_m.partial(carry_tree(frozen))
    for f in ("counts", "lo", "hi", "cat", "adv"):
        assert np.array_equal(getattr(part, f), getattr(want_part, f)), f


@pytest.mark.parametrize("case", ["1800", "8000", "one_leaf"])
def test_leafwise_scan_and_scatter_give_the_stable_argsort(case, tpch_1800,
                                                           tpch_8000):
    frozen, records = leafwise_case(case, tpch_1800, tpch_8000)
    ids = frozen.route(records)
    hist, offsets, order = leafwise_sort(ids, frozen.n_leaves)
    np.testing.assert_array_equal(
        order, torch.argsort(torch.from_numpy(ids), stable=True).numpy())
    assert offsets[-1] == ids.shape[0] and (np.diff(offsets) == hist).all()
    np.testing.assert_array_equal(ids[order][offsets[:-1][hist > 0]],
                                  np.flatnonzero(hist))


@pytest.fixture(scope="module")
def pallas_1300(tpch_1300):
    """The Pallas kernel's outputs (interpret mode) on 1,300 leaves."""
    frozen, records = tpch_1300
    k, rec, valid = pallas_operands(frozen, records)
    return tuple(np.asarray(x) for x in rfk.fused_ingest_pallas(
        rec, valid, *(jnp.asarray(k[n]) for n in (
            "dim_onehot", "cutpoint", "in_mask_t", "is_cat", "cat_off",
            "adv_cols", "adv_sel", "kind", "pathpos", "pathneg", "leafid",
        )),
        tile_m=TILE_M, tile_l=rplan.LANE, n_cat_bits=k["n_cat_bits"],
        n_adv=k["n_adv"], interpret=True,
    ))


@pytest.mark.parametrize("chunk", LEAFWISE_MODEL_CHUNKS)
def test_leafwise_model_matches_pallas_past_one_block(chunk, tpch_1300,
                                                      pallas_1300):
    frozen, records = tpch_1300
    bids, counts, lo, hi, cat, advt, advf = pallas_1300
    acc = tfk.IngestAccumulator(port_operands(frozen))
    got = leafwise_fold_model(records, port_operands(frozen), acc, chunk)
    m, L = records.shape[0], frozen.n_leaves
    bits, na = frozen.leaf_cat.shape[1], frozen.cuts.n_adv
    np.testing.assert_array_equal(got, bids[:m, 0] - 1)
    np.testing.assert_array_equal(acc.counts.numpy(), counts[0, :L])
    ne = counts[0, :L] > 0
    np.testing.assert_array_equal(acc.lo.numpy()[ne], lo[:L][ne])
    np.testing.assert_array_equal(acc.hi.numpy()[ne], hi[:L][ne])
    np.testing.assert_array_equal(
        tops.unpack_words(acc.cat.numpy(), bits), cat[:L, :bits] != 0)
    np.testing.assert_array_equal(
        tops.unpack_words(acc.advt.numpy(), na), advt[:L, :na] != 0)
    np.testing.assert_array_equal(
        tops.unpack_words(acc.advf.numpy(), na), advf[:L, :na] != 0)


OPTIN = 232_448  # an H100's opt-in shared bytes a block
TPCH_SHAPE = (21, 5, 1, 11, 3)  # columns, cat and adv words, cat columns, adv


# (kernel, warps, shared bytes, staged nodes) of route_descend's plan at
# tpch-40M's 21 columns, by leaves (2 L - 1 nodes)
ROUTE_PLANS = {
    724: ("shared", 32, 16 * 1447 + 32 * 2688, 0),  # the main layout
    # the finer layout: the shared kernel would take two blocks of 28 warps
    1250: ("prefix", 21, 66_560, 632),
    3000: ("shared", 32, 16 * 5999 + 32 * 2688, 0),  # one block of 32
    6000: ("prefix", 21, 66_560, 632),  # past SHARED_MAX_NODES
    8000: ("prefix", 21, 66_560, 632),
    20_000: ("prefix", 21, 66_560, 632),
}


@pytest.mark.parametrize("n_leaves", sorted(ROUTE_PLANS))
def test_descend_plan_by_shape(n_leaves):
    n_nodes = 2 * n_leaves - 1
    plan = trk.descend_plan(n_nodes, 21, OPTIN)
    kernel, warps, smem, prefix = ROUTE_PLANS[n_leaves]
    assert plan == trk.RoutePlan(trk.VARIANTS[kernel], warps, smem, 0,
                                 prefix)
    assert plan.smem <= OPTIN
    shared = trk.descend_plan(n_nodes, 21, OPTIN, "shared")
    if kernel == "shared":
        assert shared == plan and n_nodes <= trk.SHARED_MAX_NODES
        # two blocks of 32 warps an SM on the main layout, one past it
        assert trk.blocks_per_sm(plan.warps, plan.smem, OPTIN) == (
            2 if n_leaves == 724 else 1)
    else:  # two blocks and their reserves leave L1 124 KB of 256
        assert (shared.warps < trk.MAX_WARPS
                or n_nodes > trk.SHARED_MAX_NODES)
        assert plan.prefix < n_nodes
        assert 2 * (plan.smem + trk.RESERVED_BYTES) <= 132 * 1024
        assert trk.descend_plan(n_nodes, 21, OPTIN, "prefix") == plan
    # forced, the other kernels: the global one always, the shared one
    # where a warp's tile fits beside the tree, the prefix one staging it
    assert trk.descend_plan(n_nodes, 21, OPTIN, "global") == trk.RoutePlan(
        trk.VARIANTS["global"], trk.GLOBAL_WARPS, 0)
    fit = trk.shared_fit(n_nodes, 21, OPTIN)
    assert shared.smem == 16 * n_nodes + shared.warps * 2688
    assert (shared.smem <= OPTIN) == (fit >= 1)
    small = trk.descend_plan(n_nodes, 21, OPTIN, "prefix", 16, 100)
    assert small == trk.RoutePlan(trk.VARIANTS["prefix"], 16,
                                  1600 + 16 * 2688, 0, 100)
    # 32 warps' tiles do not fit PREFIX_BYTES: the prefix fills the block
    assert trk.descend_plan(n_nodes, 21, OPTIN, "prefix", 32) == \
        trk.RoutePlan(trk.VARIANTS["prefix"], 32,
                      16 * min(n_nodes, 9152) + 32 * 2688, 0,
                      min(n_nodes, 9152))


def test_descend_plan_refuses_a_prefix_kernel_that_cannot_fit():
    """Forced, the prefix kernel raises where one warp's tile and the root
    do not fit, or it would stage no node or more than the tree has;
    unforced, such a shape takes the global kernel."""
    wide = 232_448 // 128  # one warp's tile of this many columns is optin
    with pytest.raises(ValueError, match="do not fit"):
        trk.descend_plan(100, wide, OPTIN, "prefix")
    with pytest.raises(ValueError, match="do not fit"):
        trk.descend_plan(100, 100, OPTIN, "prefix", warps=32)  # 410 KB
    with pytest.raises(ValueError, match="cannot stage"):
        trk.descend_plan(100, 21, OPTIN, "prefix", prefix=101)
    assert trk.descend_plan(100, wide - 1, OPTIN, "prefix").warps == 1
    assert trk.descend_plan(100_000, wide - 1, OPTIN).kernel == \
        trk.VARIANTS["global"]
    with pytest.raises(ValueError, match="unknown"):
        trk.descend_plan(100, 21, OPTIN, "cluster")


def cluster_owner(plan, leaf):
    """(range, block, leaf slot) of ``leaf`` in the cluster kernel's split,
    as ``csrc/fused_ingest.cu::fused_ingest_cluster`` maps it."""
    r = leaf % plan.ranges
    rest = leaf // plan.ranges
    return r, rest % plan.cluster, rest // plan.cluster


@pytest.mark.parametrize("shape", [
    (724, *TPCH_SHAPE), (1250, *TPCH_SHAPE), (1800, *TPCH_SHAPE),
    (7500, *TPCH_SHAPE), (20_000, *TPCH_SHAPE),
    (200, 160, 2, 1, 1, 1),  # the last: wide_case
], ids=["724", "1250", "1800", "7500", "20000", "wide"])
def test_layout_plan_splits_every_leaf_once(shape):
    L = shape[0]
    planned = tfk.layout_plan(shape, OPTIN)
    if L == 724:  # tpch-40M's main layout fits one block
        assert planned.kernel == tfk.VARIANTS["shared"]
        assert tfk.shared_warps_fit(shape, OPTIN) == planned.warps == 32
        assert planned.smem <= OPTIN
        return
    assert tfk.shared_warps_fit(shape, OPTIN) < tfk.MIN_WARPS
    # the cluster kernel's split, which the plan takes or a caller forces
    plan = tfk.layout_plan(shape, OPTIN, "cluster")
    assert plan.smem <= OPTIN and plan.warps >= tfk.MIN_WARPS
    # unforced, the leafwise design where route_descend_prefix's warps fit
    # beside its histogram, else the global kernel (160 columns); the
    # cluster kernel only forced: two
    # blocks of 32 warps at the finer layout's 1,250 leaves, fewer warps or
    # more blocks past it (1,800 leaves leave a block 17 warps)
    assert planned == (tfk.leafwise_plan(shape, OPTIN)
                       if L in (1250, 1800, 7500, 20_000)
                       else tfk.Plan(tfk.VARIANTS["global"], 8, 0))
    assert ((plan.cluster, plan.warps) == (2, 32)) == (L == 1250)
    owners = {cluster_owner(plan, leaf) for leaf in range(L)}
    assert len(owners) == L  # one (range, block, slot) a leaf
    assert all(r < plan.ranges and b < plan.cluster and s < plan.per_block
               for r, b, s in owners)
    # the smallest cluster that holds the tree, else the fewest ranges
    cap = tfk.block_leaves(shape, OPTIN, plan.cluster)
    assert plan.cluster * cap * plan.ranges >= L
    smaller = [c for c in tfk.CLUSTER_SIZES if c < plan.cluster]
    assert all(c * tfk.block_leaves(shape, OPTIN, c) < L for c in smaller)
    if plan.ranges > 1:
        assert plan.cluster == tfk.CLUSTER_SIZES[-1]
        assert plan.cluster * cap * (plan.ranges - 1) < L
    # the bytes a block asks for: its slice, the tables, its warps' tiles
    # and inbox shares, the inboxes' counts
    assert plan.smem == (
        plan.per_block * tfk.leaf_bytes(shape) + tfk.table_bytes(shape) + 8
        + plan.warps * (tfk.tile_bytes(shape[1])
                        + tfk.inbox_bytes(plan.cluster)))


@pytest.mark.parametrize("n_leaves", [1, 31, 33, 723, 724, 900])
def test_shared_plan_counts_a_changed_bit_a_leaf(n_leaves):
    """The shared kernel's bytes: the aggregates, the tables and a bit a
    leaf for the leaves a block's rows changed (4 * ceil(L / 32) bytes),
    then as many 32-row tiles as fit (csrc/fused_ingest.cu's
    fused_ingest_plan checks the same bit words)."""
    shape = (n_leaves, *TPCH_SHAPE)
    fixed = (n_leaves * tfk.leaf_bytes(shape) + tfk.table_bytes(shape)
             + 4 * -(-n_leaves // 32))
    assert tfk.shared_fixed_bytes(shape) == fixed
    tile = tfk.tile_bytes(shape[1])
    plan = tfk.layout_plan(shape, OPTIN, "shared")
    assert plan.warps == tfk.shared_warps_fit(shape, OPTIN) == min(
        tfk.MAX_WARPS, (OPTIN - fixed) // tile)
    assert plan.smem == fixed + plan.warps * tile <= OPTIN


# by leaves at tpch-40M's shape: the plan's design, and the leafwise
# design's warps and shared bytes (forced, or the plan's): its route's block
# is route_descend_prefix's 632 nodes and 21 warps' tiles (66,560 bytes)
# plus 4 bytes a leaf, two blocks an SM up to 12,288 leaves, then one block
# of as many warps as fit (at most 32); the plan takes it while 21 warps
# fit (41,472 leaves)
LEAFWISE_PLANS = {
    724: ("shared", 21, 66_560 + 4 * 724),
    1250: ("leafwise", 21, 66_560 + 4 * 1250),
    1800: ("leafwise", 21, 66_560 + 4 * 1800),
    7167: ("leafwise", 21, 66_560 + 4 * 7167),
    7168: ("leafwise", 21, 66_560 + 4 * 7168),
    8000: ("leafwise", 21, 66_560 + 4 * 8000),
    12_288: ("leafwise", 21, 66_560 + 4 * 12_288),
    12_289: ("leafwise", 32, 10_112 + 32 * 2688 + 4 * 12_289),
    16_383: ("leafwise", 32, 10_112 + 32 * 2688 + 4 * 16_383),
    16_384: ("leafwise", 32, 10_112 + 32 * 2688 + 4 * 16_384),
    20_000: ("leafwise", 32, 10_112 + 32 * 2688 + 4 * 20_000),
    41_472: ("leafwise", 21, 10_112 + 21 * 2688 + 4 * 41_472),
    41_473: ("global", 20, 10_112 + 20 * 2688 + 4 * 41_473),
    50_000: ("global", 8, 10_112 + 8 * 2688 + 4 * 50_000),
}


@pytest.mark.parametrize("n_leaves", sorted(LEAFWISE_PLANS))
def test_layout_plan_takes_the_leafwise_design(n_leaves):
    shape = (n_leaves, *TPCH_SHAPE)
    kernel, warps, smem = LEAFWISE_PLANS[n_leaves]
    plan = tfk.layout_plan(shape, OPTIN)
    assert plan.kernel == tfk.VARIANTS[kernel]
    forced = tfk.layout_plan(shape, OPTIN, "leafwise")
    assert (forced.warps, forced.smem) == (warps, smem) and smem <= OPTIN
    assert forced.prefix == 632
    assert forced.most == forced.cluster == forced.ranges == 0
    assert tfk.leafwise_reaches(shape, OPTIN) == (n_leaves <= 41_472)
    if n_leaves > 724:  # past one block: leafwise wherever it reaches
        assert (kernel == "leafwise") == (n_leaves <= 41_472)
    if kernel == "leafwise":
        assert plan == forced
    elif kernel == "global":
        assert plan == tfk.Plan(tfk.VARIANTS["global"], 8, 0)
    two = trk.blocks_per_sm(warps, smem, OPTIN) >= 2
    assert two == (warps == 21 and n_leaves <= 12_288)
    # the route's warps may be forced
    assert tfk.layout_plan(shape, OPTIN, "leafwise", 8) == \
        forced._replace(warps=8, smem=forced.smem - (forced.warps - 8) * 2688)


def test_leafwise_plan_on_shapes_it_cannot_take():
    """Unforced, wide_case's 160 columns take the global kernel (21 warps'
    tiles do not fit); forced, the leafwise route stages the root alone
    beside as many warps as fit.  Past 256 columns or 32 advanced-cut
    words the fold cannot run: forcing it raises."""
    wide = (200, 160, 2, 1, 1, 1)
    assert tfk.layout_plan(wide, OPTIN) == tfk.Plan(tfk.VARIANTS["global"],
                                                    8, 0)
    forced = tfk.layout_plan(wide, OPTIN, "leafwise")
    assert (forced.prefix, forced.warps) == (1, 11)
    assert forced.smem == 16 + 800 + 11 * 4 * 32 * 160 <= OPTIN
    for shape in ((200, 257, 2, 1, 1, 1), (2000, 21, 5, 33, 11, 1040)):
        assert not tfk.leafwise_reaches(shape, OPTIN)
        assert tfk.layout_plan(shape, OPTIN).kernel == tfk.VARIANTS["global"]
        with pytest.raises(ValueError, match="leafwise fold takes at most"):
            tfk.layout_plan(shape, OPTIN, "leafwise")


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
