"""The port's block store, elastic scheduler and training pipeline against
``repro.data.pipeline`` on the CPU.

The reference's pipeline tests, each on both packages from the same seeded
records and the same greedy tree: store scans equal a brute-force filter
and the reference's scan; the scheduler's hand-out order, work stealing
and checkpoint state, ``records_to_tokens`` and every pipeline batch equal
the reference's with ``np.array_equal``.  The port's curation routes the
query through its store engine (``device="cpu"``: the plain
``query_intersect``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import greedy as rgreedy  # noqa: E402
from repro.core import query as rqry  # noqa: E402
from repro.data import datagen as rdatagen  # noqa: E402
from repro.data import pipeline as rpipe  # noqa: E402
from repro.data import workload as rwl  # noqa: E402
from repro.data.blocks import BlockStore as RStore  # noqa: E402
from repro_torch.core import greedy  # noqa: E402
from repro_torch.core import query as qry  # noqa: E402
from repro_torch.data.blocks import BlockStore  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    ElasticBlockScheduler,
    PipelineConfig,
    QdTreePipeline,
    records_to_tokens,
)
from tests.test_torch_woodblock import to_port  # noqa: E402


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same 5,000-row errorlog table stored by both packages, each on
    its own package's greedy tree (equal arrays)."""
    schema, records = rdatagen.make_errorlog_int(5_000, seed=0)
    work, _ = rwl.make_errorlog_int_workload(schema, n_queries=40, seed=0)
    cuts = work.candidate_cuts()
    rtree = rgreedy.build_greedy(records, work, cuts,
                                 rgreedy.GreedyConfig(min_block=250))
    ttree = greedy.build_greedy(records, to_port(work), to_port(cuts),
                                greedy.GreedyConfig(min_block=250))
    ref = RStore.create(tmp_path_factory.mktemp("ref"), rtree.freeze(),
                        records)
    port = BlockStore.create(tmp_path_factory.mktemp("port"),
                             ttree.freeze(), records, device="cpu")
    return port, ref, to_port(schema), records, to_port(work), work


def _sorted(rows):
    return rows[np.lexsort(rows.T)] if rows.size else rows


def test_scan_query_exact(stores):
    port, ref, schema, records, work, rwork = stores
    np.testing.assert_array_equal(port.sizes, ref.sizes)
    for q, rq in zip(work.queries[:10], rwork.queries[:10]):
        res = port.scan_query(q)
        truth = records[q.evaluate(records, schema)]
        np.testing.assert_array_equal(_sorted(res.rows), _sorted(truth))
        want = ref.scan_query(rq)
        np.testing.assert_array_equal(res.rows, want.rows)
        assert (res.blocks_read, res.bytes_read, res.rows_scanned) == (
            want.blocks_read, want.bytes_read, want.rows_scanned)
        assert res.blocks_read <= port.tree.n_leaves
        assert res.bytes_read == res.rows_scanned * port.row_bytes


def test_scan_skips_blocks(stores):
    port, _, _, _, work, _ = stores
    reads = [port.scan_query(q).blocks_read for q in work.queries[:30]]
    assert np.mean(reads) < 0.5 * port.tree.n_leaves


def test_store_roundtrip(stores):
    port, ref, _, _, work, _ = stores
    reopened = BlockStore.open(port.root, device="cpu")
    assert reopened.tree.n_leaves == port.tree.n_leaves
    q = work.queries[0]
    np.testing.assert_array_equal(reopened.scan_query(q).rows,
                                  port.scan_query(q).rows)
    # the reference's store opens in the port and scans the same rows
    crossed = BlockStore.open(ref.root, device="cpu")
    np.testing.assert_array_equal(crossed.scan_query(q).rows,
                                  port.scan_query(q).rows)


# ---------------------------------------------------------------------------
# elastic scheduler
# ---------------------------------------------------------------------------
def _stealing_run(cls):
    s = cls(list(range(10)), seed=0)
    w0 = [s.next_block(0) for _ in range(4)]
    w1 = [s.next_block(1) for _ in range(3)]
    lost = s.fail(0)
    assert sorted(lost) == sorted(w0)
    stolen = [s.next_block(1) for _ in range(4)]
    assert sorted(stolen) == sorted(w0)
    for b in w1 + stolen:
        s.ack(1, b)
    rest = []
    while True:
        b = s.next_block(1)
        if b is None or s.epoch > 0:
            break
        rest.append(b)
        s.ack(1, b)
    assert s.epoch == 1
    return w0, w1, lost, stolen, rest, dataclasses.asdict(s.state())


def test_scheduler_work_stealing():
    assert _stealing_run(ElasticBlockScheduler) == _stealing_run(
        rpipe.ElasticBlockScheduler)


@pytest.mark.parametrize("seed", [0, 7])
def test_scheduler_epoch_shuffles_deterministically(seed):
    a = ElasticBlockScheduler(list(range(8)), seed=seed)
    b = ElasticBlockScheduler(list(range(8)), seed=seed)
    r = rpipe.ElasticBlockScheduler(list(range(8)), seed=seed)
    seq_a = [a.next_block(0) for _ in range(8)]
    assert seq_a == [b.next_block(0) for _ in range(8)]
    assert seq_a == [r.next_block(0) for _ in range(8)]
    assert sorted(seq_a) == list(range(8))


def test_scheduler_checkpoint_restore():
    def run(cls):
        s = cls(list(range(6)), seed=1)
        done = [s.next_block(0) for _ in range(2)]
        for b in done:
            s.ack(0, b)
        inflight = s.next_block(0)
        st = s.state()
        s2 = cls(list(range(6)), seed=1)
        s2.restore(st)
        remaining = []
        while True:
            b = s2.next_block(0)
            if b is None or s2.epoch > st.epoch:
                break
            remaining.append(b)
            s2.ack(0, b)
        assert sorted(remaining + done) == list(range(6))
        assert inflight in remaining
        return dataclasses.asdict(st), remaining

    assert run(ElasticBlockScheduler) == run(rpipe.ElasticBlockScheduler)


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------
def test_tokens_deterministic():
    rows = np.arange(12, dtype=np.int32).reshape(3, 4)
    a = records_to_tokens(rows, 16, 1000, seed=1)
    np.testing.assert_array_equal(a, records_to_tokens(rows, 16, 1000, 1))
    np.testing.assert_array_equal(
        a, rpipe.records_to_tokens(rows, 16, 1000, seed=1))
    c = records_to_tokens(rows, 16, 1000, seed=2)
    assert not np.array_equal(a, c)
    big = np.random.default_rng(4).integers(0, 1 << 20, (64, 7)).astype(
        np.int32)
    np.testing.assert_array_equal(records_to_tokens(big, 9, 512, 3),
                                  rpipe.records_to_tokens(big, 9, 512, 3))


def _pipelines(stores, atoms, **cfg):
    port, ref, schema, records, _, _ = stores
    d = schema.dim
    curation = qry.Query.conjunction(
        [qry.InAtom(d(c), v) for c, v in atoms])
    rcuration = rqry.Query.conjunction(
        [rqry.InAtom(d(c), v) for c, v in atoms])
    got = QdTreePipeline(port, PipelineConfig(curation_query=curation,
                                              **cfg))
    want = rpipe.QdTreePipeline(ref, rpipe.PipelineConfig(
        curation_query=rcuration, **cfg))
    return got, want, curation


def test_pipeline_curation_skips_blocks(stores):
    got, want, _ = _pipelines(
        stores, [("event_type", (0,)), ("is_valid", (1,))],
        batch_size=16, seq_len=8, vocab=100)
    assert got.blocks_skipped > 0
    assert got.block_ids == want.block_ids
    assert got.blocks_skipped == want.blocks_skipped
    toks, labels = next(iter(got))
    assert toks.shape == (16, 8) and labels.shape == (16, 8)
    assert (toks >= 0).all() and (toks < 100).all()
    rt, rl = next(iter(want))
    np.testing.assert_array_equal(toks, rt)
    np.testing.assert_array_equal(labels, rl)


def test_pipeline_batches_only_matching_records(stores):
    _, _, schema, records, _, _ = stores
    got, want, curation = _pipelines(
        stores, [("event_type", (2,))],
        batch_size=8, seq_len=4, vocab=50, epochs=1)
    n_match = int(curation.evaluate(records, schema).sum())
    batches = list(got)
    assert sum(t.shape[0] for t, _ in batches) == (n_match // 8) * 8
    ref_batches = list(want)
    assert len(batches) == len(ref_batches)
    for (t, lab), (rt, rl) in zip(batches, ref_batches):
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(lab, rl)
