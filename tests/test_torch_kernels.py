"""The port's kernels against the JAX package's Pallas kernels.

Each kernel module of ``repro_torch`` holds a CUDA kernel and a plain
PyTorch version.  On the CPU the plain versions run; here they meet the
Pallas functions of ``repro`` (interpret mode) on the same trees, records
and workloads, made from a seed with numpy.  Block ids, predicate
matrices, per-leaf aggregates and hit matrices compare exactly; the
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
from repro_torch.core import query as tqry  # noqa: E402
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


@pytest.mark.parametrize("seed", SEEDS)
def test_locate_leaf_plain_matches_pallas(seed):
    frozen, records = setup_case(seed)
    k, rec, _ = pallas_operands(frozen, records)
    m_mat = pallas_eval_cuts(k, rec)
    want = np.asarray(rrk.locate_leaf_pallas(
        jnp.asarray(m_mat), jnp.asarray(k["pathpos"]),
        jnp.asarray(k["pathneg"]), jnp.asarray(k["leafid"]),
        tile_m=TILE_M, tile_l=rplan.LANE, interpret=True,
    ))
    ops = port_operands(frozen)
    m = records.shape[0]
    got = trk.locate_leaf_plain(
        torch.from_numpy(m_mat[:m, :frozen.cuts.n_cuts].astype(np.uint8)),
        ops,
    )
    np.testing.assert_array_equal(got.numpy(), want[:m].astype(np.int32))
    np.testing.assert_array_equal(got.numpy(), frozen.route(records))


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
    out = tfk.fused_ingest_plain(torch.from_numpy(records),
                                 port_operands(frozen))
    m, L = records.shape[0], frozen.n_leaves
    bits, na = frozen.leaf_cat.shape[1], frozen.cuts.n_adv
    np.testing.assert_array_equal(out.bids.numpy(), bids[:m, 0] - 1)
    np.testing.assert_array_equal(out.counts.numpy(), counts[0, :L])
    ne = counts[0, :L] > 0
    # occupied leaves carry the same bounds; empty ones each side's identity
    np.testing.assert_array_equal(out.lo.numpy()[ne], lo[:L][ne])
    np.testing.assert_array_equal(out.hi.numpy()[ne], hi[:L][ne])
    assert (out.lo.numpy()[~ne] == tfk.I32_MAX).all()
    assert (out.hi.numpy()[~ne] == tfk.I32_MIN).all()
    np.testing.assert_array_equal(out.cat.numpy(), cat[:L, :bits])
    np.testing.assert_array_equal(out.advt.numpy()[:, :na], advt[:L, :na])
    np.testing.assert_array_equal(out.advf.numpy()[:, :na], advf[:L, :na])


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
    n_adv = frozen.cuts.n_adv
    tree = carry_tree(frozen)
    tree.block_sizes = sizes
    hits, scanned = tqk.query_intersect_plain(
        tplan.to_device(tplan.pack_leaf_descs(tree), "cpu"),
        tplan.to_device(tops.pack_workload(carry_wt(wt), n_adv), "cpu"),
        tplan.to_device(tops.query_layout(tree.schema, n_adv), "cpu"),
    )
    np.testing.assert_array_equal(hits.numpy().astype(bool), conj)
    np.testing.assert_array_equal(
        scanned.numpy(), (conj * sizes[:, None]).sum(axis=0)
    )
