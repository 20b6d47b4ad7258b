"""The port's sharded ingest against the JAX package's, on the CPU.

Trees from ``repro`` carry over through their ``.npz`` (``carry_tree``);
the port's engine runs on ``device="cpu"``, where ``fused_ingest`` takes
its plain version.  For every shard count the port's tightened tree,
block sizes and window stats equal ``repro``'s ``sharded_ingest`` (numpy
backend) and the port's own single-stream ``ingest``, array for array.
A ``ShardState`` saved by either package loads in the other.  ``repro`` is
only the oracle here.
"""

import collections
import os
import sys
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import query as rqry  # noqa: E402
from repro.engine import LayoutEngine as RefEngine  # noqa: E402
from repro.engine import sharded as rsharded  # noqa: E402
from repro_torch.engine import LayoutEngine  # noqa: E402
from repro_torch.engine import sharded as tsharded  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from tests.test_qdtree import random_tree, small_setup  # noqa: E402
from tests.test_query import random_query  # noqa: E402
from tests.test_torch_kernels import carry_tree, carry_wt  # noqa: E402

LEAF_FIELDS = ("leaf_lo", "leaf_hi", "leaf_cat", "leaf_adv")
STATE_FIELDS = ("counts", "lo", "hi", "cat", "adv")
BATCH = 53


def _case(seed, m=900):
    schema, records, cuts = small_setup(seed, m=m)
    rng = np.random.default_rng(seed)
    frozen = random_tree(schema, cuts, records, rng, max_splits=14).freeze()
    queries = tuple(random_query(schema, rng) for _ in range(5))
    return frozen, records, rqry.Workload(schema, queries)


def _assert_trees_equal(port, ref):
    for f in LEAF_FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), f)


def _assert_states_equal(a, b):
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert a.shard_ids == b.shard_ids
    assert (a.n_leaves, a.n_batches, a.n_records) == (
        b.n_leaves, b.n_batches, b.n_records)
    assert a.obs.to_array().tolist() == b.obs.to_array().tolist()
    assert sorted(a.chunks) == sorted(b.chunks)
    for blk in a.chunks:
        assert [s for s, _ in a.chunks[blk]] == [s for s, _ in b.chunks[blk]]
        for (_, x), (_, y) in zip(a.chunks[blk], b.chunks[blk]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_thread_shards_match_repro_and_single_stream(k):
    frozen, records, work = _case(k)
    wt = work.tensorize(frozen.cuts)
    ref_tree = rsharded.replicate_tree(frozen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", rsharded.PerformanceWarning)
        ref = rsharded.sharded_ingest(
            RefEngine(ref_tree, backend="numpy"), records, k, batch=BATCH,
            executor="thread", observe=work,
        )
    port = carry_tree(frozen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", tsharded.PerformanceWarning)
        rep = tsharded.sharded_ingest(
            LayoutEngine(port, device="cpu"), records, k, batch=BATCH,
            executor="thread", observe=carry_wt(wt), keep_state=True,
        )
    single = carry_tree(frozen)
    one = LayoutEngine(single, device="cpu").ingest(
        tsharded.micro_batches(records, BATCH), observe=carry_wt(wt))
    assert rep.published and rep.n_shards == k
    assert len(rep.shard_wall_s) == k and rep.n_records == records.shape[0]
    for want_tree, want_sizes, want_obs in (
        (ref_tree, ref.block_sizes, ref.observation),
        (single, one.block_sizes, one.observation),
    ):
        _assert_trees_equal(port, want_tree)
        np.testing.assert_array_equal(rep.block_sizes, want_sizes)
        assert rep.observation.to_array().tolist() == (
            want_obs.to_array().tolist())
    np.testing.assert_array_equal(port.block_sizes, ref.block_sizes)
    assert rep.state.shard_ids == tuple(range(k))


@pytest.mark.parametrize("fused", [True, False])
def test_shard_ingestor_states_match_repro(fused):
    """One shard's state on the torch (plain) and numpy backends, fused
    and two-pass, equals ``repro``'s ShardIngestor field for field."""
    frozen, records, _ = _case(4)
    batches = list(tsharded.micro_batches(records, BATCH))
    want = rsharded.ShardIngestor(
        RefEngine(rsharded.replicate_tree(frozen), backend="numpy"),
        shard_id=3, collect_blocks=True, fused=fused,
    ).run(batches)
    for backend in ("torch", "numpy"):
        got = tsharded.ShardIngestor(
            LayoutEngine(carry_tree(frozen), device="cpu"), shard_id=3,
            backend=backend, collect_blocks=True, fused=fused,
        ).run(batches)
        _assert_states_equal(got, want)


def test_tensor_records_shard_as_views():
    frozen, records, _ = _case(2)
    rec = torch.from_numpy(records)
    parts = tsharded.shard_slices(rec, 4)
    want = np.array_split(records, 4)
    assert [p.shape[0] for p in parts] == [w.shape[0] for w in want]
    assert all(p.data_ptr() >= rec.data_ptr() for p in parts)  # views
    port = carry_tree(frozen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", tsharded.PerformanceWarning)
        tsharded.sharded_ingest(LayoutEngine(port, device="cpu"), rec, 4,
                                batch=BATCH, executor="thread")
    single = carry_tree(frozen)
    LayoutEngine(single, device="cpu").ingest(
        tsharded.micro_batches(records, BATCH))
    _assert_trees_equal(port, single)


def test_process_shards_come_up_on_the_parent_device():
    """k = 2 spawn workers: a CPU parent gives CPU workers, whose merged
    result equals ``repro``'s; a worker asked for a CUDA device it does
    not have raises instead of running on the CPU."""
    frozen, records, _ = _case(9)
    ref_tree = rsharded.replicate_tree(frozen)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", rsharded.PerformanceWarning)
        ref = rsharded.sharded_ingest(
            RefEngine(ref_tree, backend="numpy"), records, 2, batch=BATCH,
            executor="thread",
        )
    port = carry_tree(frozen)
    eng = LayoutEngine(port, device="cpu")
    with tsharded.ProcessShardSession(eng, 2, batch=BATCH) as sess:
        assert sess.device == "cpu"
        rep = tsharded.sharded_ingest(eng, records, 2, batch=BATCH,
                                      session=sess)
        assert set(sess.worker_devices().values()) == {"cpu"}
    assert rep.published
    _assert_trees_equal(port, ref_tree)
    np.testing.assert_array_equal(rep.block_sizes, ref.block_sizes)
    if not torch.cuda.is_available():
        with tsharded.ProcessShardSession(
                LayoutEngine(carry_tree(frozen), device="cpu"), 2,
                batch=BATCH) as bad:
            bad.device = "cuda"
            with pytest.raises(RuntimeError, match="no CUDA device"):
                bad.round(records)


def test_shard_state_npz_crosses_packages(tmp_path):
    frozen, records, work = _case(6)
    probe = RefEngine(frozen, backend="numpy").observation_probe(work)
    parts = tsharded.shard_slices(records, 2)
    port_state = tsharded.ShardIngestor(
        LayoutEngine(carry_tree(frozen), device="cpu"), shard_id=1,
        collect_blocks=True,
        probe=tsharded.ObservationProbe(probe.per_leaf, probe.n_queries),
    ).run(tsharded.micro_batches(parts[1], BATCH))
    ref_state = rsharded.ShardIngestor(
        RefEngine(rsharded.replicate_tree(frozen), backend="numpy"),
        shard_id=1, collect_blocks=True, probe=probe,
    ).run(rsharded.micro_batches(parts[1], BATCH))
    port_state.save(str(tmp_path / "port.npz"))
    ref_state.save(str(tmp_path / "ref.npz"))
    in_ref = rsharded.ShardState.load(str(tmp_path / "port.npz"))
    in_port = tsharded.ShardState.load(str(tmp_path / "ref.npz"))
    for a, b in ((in_ref, ref_state), (in_port, port_state),
                 (in_port, in_ref)):
        _assert_states_equal(a, b)
    assert rsharded.states_bit_identical(in_ref, ref_state)
    assert tsharded.states_bit_identical(in_port, port_state)


def test_replicate_tree_copies_block_sizes():
    frozen, records, _ = _case(1)
    port = carry_tree(frozen)
    LayoutEngine(port, device="cpu").ingest([records])
    rep = tsharded.replicate_tree(port)
    np.testing.assert_array_equal(rep.block_sizes, port.block_sizes)
    assert rep.block_sizes is not port.block_sizes
    for f in ("cut_id", "left", "right", "leaf_bid", *LEAF_FIELDS):
        np.testing.assert_array_equal(getattr(rep, f), getattr(port, f))
        assert getattr(rep, f) is not getattr(port, f)


def test_resolve_executor():
    with pytest.raises(ValueError, match="executor must be"):
        tsharded.resolve_executor("fork", 2)
    with pytest.raises(ValueError, match="executor must be"):
        tsharded.resolve_executor("threads", 1, device="cpu")
    assert tsharded.resolve_executor(None, 1) == "thread"
    assert tsharded.resolve_executor(None, 4, device="cpu") == "process"
    assert tsharded.resolve_executor(None, 4, device="cuda") == (
        tsharded.CUDA_DEFAULT_EXECUTOR)
    with pytest.warns(tsharded.PerformanceWarning, match="GIL"):
        tsharded.resolve_executor("thread", 4, device="cpu")
    other = {"thread": "process", "process": "thread"}[
        tsharded.CUDA_DEFAULT_EXECUTOR]
    with pytest.warns(tsharded.PerformanceWarning, match="GPU"):
        tsharded.resolve_executor(other, 4, device="cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tsharded.resolve_executor("thread", 1, device="cpu")
        tsharded.resolve_executor("process", 4, device="cpu")


class _YieldingCounter(collections.Counter):
    """A counter that lets another thread run between reading a count and
    writing it back, so an update made without the lock is lost."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counter_is_exact_under_threads(monkeypatch):
    """More threads than cores count launches at once, with a short switch
    interval and a counter that yields inside each update; none is lost."""
    monkeypatch.setattr(_build, "LAUNCHES", _YieldingCounter())
    n, per = max(8, (os.cpu_count() or 1) + 1), 2_000
    start = threading.Barrier(n)

    def count():
        start.wait(timeout=30)
        for _ in range(per):
            _build.count_launch("fused_ingest_shared")

    threads = [threading.Thread(target=count) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    counts = _build.launch_counts()
    assert counts["fused_ingest_shared"] == n * per
    assert sum(counts.values()) == n * per
