"""The port's block buffers and block store against the JAX package's.

On the CPU: ingest spill (single-stream, with numpy batches and with
tensor batches, whose sort by block runs in torch, and sharded at every
shard count) fills buffers that equal ``repro``'s row for row; a store
written by either package opens in the other, and its scans return the
rows of ``repro``'s scan and of a brute-force filter.  ``repro`` is only
the oracle here.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import blocks as rblocks  # noqa: E402
from repro.engine import LayoutEngine as RefEngine  # noqa: E402
from repro.engine import sharded as rsharded  # noqa: E402
from repro_torch.data import blocks as tblocks  # noqa: E402
from repro_torch.engine import LayoutEngine, engine_for  # noqa: E402
from repro_torch.engine import sharded as tsharded  # noqa: E402
from tests.test_torch_engine import _port_query  # noqa: E402
from tests.test_torch_kernels import carry_tree, uneven_batches  # noqa: E402
from tests.test_torch_sharded import BATCH, _case  # noqa: E402


def _ref_buffers(frozen, batches):
    tree = rsharded.replicate_tree(frozen)
    buf = rblocks.BlockBuffers.for_tree(tree)
    RefEngine(tree, backend="numpy").ingest(batches, buffers=buf)
    return tree, buf


def _assert_buffers_equal(got, want):
    np.testing.assert_array_equal(got.sizes, want.sizes)
    assert got.n_rows == want.n_rows and got.dtype == want.dtype
    for b in range(want.n_blocks):
        np.testing.assert_array_equal(got.block(b), want.block(b))


@pytest.mark.parametrize("as_tensor", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_single_stream_spill_matches_repro(seed, as_tensor):
    frozen, records, _ = _case(seed)
    batches = uneven_batches(records, 5, np.random.default_rng(seed))
    _, want = _ref_buffers(frozen, batches)
    port = carry_tree(frozen)
    got = tblocks.BlockBuffers.for_tree(port)
    feed = [torch.from_numpy(b) for b in batches] if as_tensor else batches
    rep = LayoutEngine(port, device="cpu").ingest(feed, buffers=got)
    np.testing.assert_array_equal(rep.block_sizes, want.sizes)
    _assert_buffers_equal(got, want)


@pytest.mark.parametrize("fused", [True, False])
def test_two_pass_and_untightened_spill_match_repro(fused):
    frozen, records, _ = _case(3)
    batches = list(tsharded.micro_batches(records, BATCH))
    _, want = _ref_buffers(frozen, batches)
    for tighten in (True, False):
        got = tblocks.BlockBuffers.for_tree(frozen)
        LayoutEngine(carry_tree(frozen), device="cpu").ingest(
            [torch.from_numpy(b) for b in batches], buffers=got,
            tighten=tighten, fused=fused)
        _assert_buffers_equal(got, want)


def test_sort_by_block_is_a_stable_host_sort():
    rng = np.random.default_rng(0)
    rec = rng.integers(-5, 5, (4000, 3)).astype(np.int32)
    bids = rng.integers(0, 37, 4000).astype(np.int32)
    got, counts = tblocks.sort_by_block(torch.from_numpy(rec),
                                        torch.from_numpy(bids), 40)
    np.testing.assert_array_equal(got, rec[np.argsort(bids, kind="stable")])
    np.testing.assert_array_equal(counts, np.bincount(bids, minlength=40))
    with pytest.raises(ValueError, match="int32"):
        tblocks.sort_by_block(torch.from_numpy(rec).long(),
                              torch.from_numpy(bids), 40)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_sharded_spill_matches_repro_single_stream(k):
    frozen, records, _ = _case(7)
    _, want = _ref_buffers(frozen, list(tsharded.micro_batches(records,
                                                               BATCH)))
    port = carry_tree(frozen)
    got = tblocks.BlockBuffers.for_tree(port)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", tsharded.PerformanceWarning)
        tsharded.sharded_ingest(
            LayoutEngine(port, device="cpu"), torch.from_numpy(records), k,
            batch=BATCH, executor="thread", buffers=got,
        )
    _assert_buffers_equal(got, want)


def _queries(work):
    return [(q, _port_query(q)) for q in work.queries]


def test_port_store_opens_in_repro_and_scans_equal(tmp_path):
    frozen, records, work = _case(11)
    port = carry_tree(frozen)
    engine_for(port, device="cpu")
    store = tblocks.BlockStore.create(tmp_path / "s", port, records,
                                      device="cpu")
    ref_store = rblocks.BlockStore.open(tmp_path / "s")
    reopened = tblocks.BlockStore.open(tmp_path / "s", device="cpu")
    np.testing.assert_array_equal(ref_store.sizes, store.sizes)
    assert ref_store.row_bytes == store.row_bytes == 12
    for b in range(port.n_leaves):
        np.testing.assert_array_equal(ref_store.read_block(b),
                                      store.read_block(b))
    for rq, tq in _queries(work):
        want = ref_store.scan_query(rq)
        brute = records[rq.evaluate(records, frozen.schema)]
        for got in (store.scan_query(tq), reopened.scan_query(tq)):
            np.testing.assert_array_equal(got.rows, want.rows)
            assert (got.blocks_read, got.bytes_read, got.rows_scanned) == (
                want.blocks_read, want.bytes_read, want.rows_scanned)
            # the same rows as a filter over the whole table, in block order
            order = np.lexsort(got.rows.T[::-1])
            np.testing.assert_array_equal(
                got.rows[order], brute[np.lexsort(brute.T[::-1])])


def test_repro_store_opens_in_port(tmp_path):
    frozen, records, work = _case(2)
    ref_store = rblocks.BlockStore.create(tmp_path / "r",
                                          rsharded.replicate_tree(frozen),
                                          records, backend="numpy")
    store = tblocks.BlockStore.open(tmp_path / "r", device="cpu")
    np.testing.assert_array_equal(store.sizes, ref_store.sizes)
    for rq, tq in _queries(work):
        np.testing.assert_array_equal(store.scan_query(tq).rows,
                                      ref_store.scan_query(rq).rows)
