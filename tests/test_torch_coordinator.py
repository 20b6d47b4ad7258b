"""The port's fleet coordinator against ``repro.coordinator`` on the CPU.

The reference's coordinator tests, each on both packages from the same
seeded records and the same prefix-built greedy tree: cadence folds
publish descriptions bit-identical to single-stream ingest and to the
reference's fold of the same partials, for every arrival order and cadence
partition; ``IngestOptions(coordinator=)`` routes locally and publishes
only through the fold; tracker deltas merge fleet-wide; stale-generation
partials are dropped; the publish CAS; worker join and leave; protocol
validation.  Section 5 of ``tests/_hash_seed_probe.py`` (k-way folds in
permuted orders) runs on the port in subprocesses under two
``PYTHONHASHSEED`` values, and its digest equals the reference's.
"""

import dataclasses
import hashlib
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.coordinator import FleetCoordinator as RCoord  # noqa: E402
from repro.core import query as rqry  # noqa: E402
from repro.engine import LayoutEngine as REngine  # noqa: E402
from repro.engine import replicate_tree as rreplicate  # noqa: E402
from repro.engine import sharded as rsharded  # noqa: E402
from repro.engine.engine import WindowStat as RWindowStat  # noqa: E402
from repro.service import IngestOptions as ROptions  # noqa: E402
from repro.service import LayoutService as RService  # noqa: E402
from repro.service import build_layout as rbuild  # noqa: E402
from repro_torch.coordinator import (  # noqa: E402
    FleetCoordinator,
    FoldReport,
    WorkerHandle,
)
from repro_torch.engine import LayoutEngine, replicate_tree  # noqa: E402
from repro_torch.engine import plan as planlib  # noqa: E402
from repro_torch.engine.sharded import (  # noqa: E402
    ShardIngestor,
    micro_batches,
)
from repro_torch.service import (  # noqa: E402
    IngestOptions,
    LayoutService,
    build_layout,
)
from tests.test_qdtree import small_setup  # noqa: E402
from tests.test_query import random_query  # noqa: E402
from tests.test_torch_woodblock import to_port  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


def _setup(seed=0, n_queries=8):
    schema, records, cuts = small_setup(seed)
    rng = np.random.default_rng(seed)
    work = rqry.Workload(
        schema, tuple(random_query(schema, rng) for _ in range(n_queries))
    )
    return schema, records, cuts, work


class Pair:
    """One scenario on both packages: the port's service (torch on the
    CPU) and the reference's (numpy), each built from a PREFIX of the
    records, so the full stream genuinely tightens the descriptions."""

    def __init__(self, seed, min_block=30):
        schema, records, cuts, work = _setup(seed)
        self.seed, self.records = seed, records
        self.schema, self.cuts, self.work = schema, cuts, work
        self.tschema, self.tcuts, self.twork = (
            to_port(schema), to_port(cuts), to_port(work))
        half = records[: len(records) // 2]
        self.port = LayoutService(build_layout(
            half, self.twork, strategy="greedy", cuts=self.tcuts,
            min_block=min_block, seed=seed, device="cpu"), device="cpu")
        self.ref = RService(rbuild(
            half, work, strategy="greedy", cuts=cuts, min_block=min_block,
            seed=seed), backend="numpy")

    def other_builds(self, seed):
        return (
            build_layout(self.records, self.twork, strategy="greedy",
                         cuts=self.tcuts, min_block=30, seed=seed,
                         device="cpu"),
            rbuild(self.records, self.work, strategy="greedy",
                   cuts=self.cuts, min_block=30, seed=seed),
        )


def _digest(tree):
    h = hashlib.sha256()
    for arr in (tree.leaf_lo, tree.leaf_hi, tree.leaf_cat, tree.leaf_adv):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _worker_state(tree, rows, batch=64, observe=None):
    """What a port worker ships: ``rows`` routed on a private replica."""
    eng = LayoutEngine(replicate_tree(tree), device="cpu")
    probe = eng.observation_probe(observe) if observe is not None else None
    return ShardIngestor(eng, shard_id=0, probe=probe).run(
        micro_batches(rows, batch))


def _ref_worker_state(tree, rows, batch=64, observe=None):
    eng = REngine(rreplicate(tree), backend="numpy")
    probe = eng.observation_probe(observe) if observe is not None else None
    return rsharded.ShardIngestor(eng, shard_id=0, probe=probe).run(
        rsharded.micro_batches(rows, batch))


def to_ref(state):
    """The reference's ShardState carrying the port state's arrays."""
    fields = {f.name: getattr(state, f.name)
              for f in dataclasses.fields(state)}
    fields["obs"] = RWindowStat(*dataclasses.astuple(state.obs))
    return rsharded.ShardState(**fields)


def assert_states_equal(port, ref):
    for f in ("counts", "lo", "hi", "cat", "adv"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), f)
    assert (port.n_batches, port.n_records) == (ref.n_batches,
                                                ref.n_records)
    assert dataclasses.astuple(port.obs) == dataclasses.astuple(ref.obs)


def _single_stream_digest(tree, records, batch=64):
    replica = replicate_tree(tree)
    LayoutEngine(replica, device="cpu").ingest(micro_batches(records, batch))
    return _digest(replica)


def _report(rep):
    out = dataclasses.asdict(rep)
    out.pop("drift")
    return out


# ---------------------------------------------------------------------------
# The cadence fold: publish parity with single-stream ingest
# ---------------------------------------------------------------------------
def test_fold_publishes_bit_identical_to_single_stream():
    p = Pair(3)
    want = _single_stream_digest(p.port.tree, p.records)
    assert _digest(p.port.tree) != want
    reports = []
    for svc, cls, state_of in ((p.port, FleetCoordinator, _worker_state),
                               (p.ref, RCoord, _ref_worker_state)):
        coord = cls(svc, cadence=2)
        a, b = coord.register("ingest-a"), coord.register("ingest-b")
        halves = np.array_split(p.records, 2)
        assert coord.submit(a, state=state_of(svc.tree, halves[0])) is None
        rep = coord.submit(b, state=state_of(svc.tree, halves[1]))
        assert rep.published and rep.n_partials == 2 and rep.fold == 1
        assert rep.n_records == len(p.records)
        assert coord.stats()["folds"] == 1 and coord.stats()["pending"] == 0
        reports.append((_report(rep), coord.stats()))
    assert reports[0] == reports[1]
    assert _digest(p.port.tree) == want == _digest(p.ref.tree)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("cadence", [1, 3])
def test_fold_commutes_over_arrival_order_and_cadence(k, cadence):
    """Any arrival order and cadence partition of the same k partials
    publishes the single stream's descriptions; the reference's
    coordinator, fed the port's partials in the same order, publishes the
    same bytes."""
    p = Pair(5)
    want = _single_stream_digest(p.port.tree, p.records)
    parts = np.array_split(p.records, k)
    states = [_worker_state(p.port.tree, part) for part in parts]
    for s, part in zip(states, parts):
        assert_states_equal(s, _ref_worker_state(p.ref.tree, part))
    order = np.random.default_rng(k * 31 + cadence).permutation(k)
    for svc, cls, conv in ((p.port, FleetCoordinator, lambda s: s),
                           (p.ref, RCoord, to_ref)):
        coord = cls(svc, cadence=cadence)
        w = coord.register()
        for i in order:
            coord.submit(w, state=conv(states[int(i)]))
        if coord.stats()["pending"]:
            coord.fold()
    assert _digest(p.port.tree) == want == _digest(p.ref.tree)


def test_coordinator_routed_service_ingest():
    """``ingest(records, IngestOptions(coordinator=))`` routes and
    aggregates locally but publishes only through the coordinator fold."""
    p = Pair(7)
    want = _single_stream_digest(p.port.tree, p.records, batch=64)
    before = _digest(p.port.tree)
    stats = []
    for svc, cls, opts in ((p.port, FleetCoordinator, IngestOptions),
                           (p.ref, RCoord, ROptions)):
        coord = cls(svc, cadence=1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # thread-executor footgun
            rep = svc.ingest(p.records, opts(
                shards=2, batch=64, executor="thread", coordinator=coord))
        assert not rep.published
        assert coord.stats()["folds"] == 1
        stats.append(coord.stats())
    assert stats[0] == stats[1]
    assert _digest(p.port.tree) == want == _digest(p.ref.tree) != before
    # one registration per coordinator object, however many runs
    coord = FleetCoordinator(p.port, cadence=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(2):
            p.port.ingest(p.records, IngestOptions(
                shards=2, batch=64, executor="thread", coordinator=coord))
    assert len(coord.workers()) == 1 and coord.stats()["folds"] == 2


# ---------------------------------------------------------------------------
# Tracker deltas and the fleet rebuilder
# ---------------------------------------------------------------------------
def test_tracker_deltas_fold_fleet_wide():
    p = Pair(9)
    snaps = []
    for svc, cls, schema, work in (
        (p.port, FleetCoordinator, p.tschema, p.twork),
        (p.ref, RCoord, p.schema, p.work),
    ):
        coord = cls(svc, cadence=2)
        a, b = coord.register(), coord.register()
        t1, t2 = svc.workload_tracker(), svc.workload_tracker()
        wl = type(work)
        t1.record(wl(schema, work.queries[:4]))
        t2.record(wl(schema, work.queries[4:]))
        coord.submit(a, tracker_state=t1.drain_state())
        rep = coord.submit(b, tracker_state=t2.drain_state())
        assert rep is not None and rep.tracker_merges == 2
        assert rep.n_partials == 0 and not rep.published
        assert not t1.snapshot().top_signatures(8)
        fleet = coord.tracker.snapshot()
        assert fleet.queries_seen == len(work.queries)
        snaps.append((fleet.queries_seen, fleet.top_signatures(16)))
    assert snaps[0] == snaps[1]


def test_fold_feeds_fleet_rebuilder_the_merged_window():
    class RecordingRebuilder:
        def __init__(self):
            self.observations = []

        def observe(self, obs):
            self.observations.append(obs)
            return "decision"

    p = Pair(11)
    seen = []
    for svc, cls, state_of, work in (
        (p.port, FleetCoordinator, _worker_state, p.twork),
        (p.ref, RCoord, _ref_worker_state, p.work),
    ):
        rb = RecordingRebuilder()
        coord = cls(svc, cadence=2, rebuilder=rb)
        w = coord.register()
        halves = np.array_split(p.records, 2)
        coord.submit(w, state=state_of(svc.tree, halves[0], observe=work))
        rep = coord.submit(
            w, state=state_of(svc.tree, halves[1], observe=work))
        assert rep.drift == "decision"
        (merged_obs,) = rb.observations
        assert merged_obs.capacity > 0
        assert merged_obs.n_records == len(p.records)
        seen.append(dataclasses.astuple(merged_obs))
    assert seen[0] == seen[1]


# ---------------------------------------------------------------------------
# Staleness, racing swaps, membership, protocol validation
# ---------------------------------------------------------------------------
def test_stale_generation_partials_are_dropped():
    p = Pair(13)
    others = p.other_builds(99)
    reports = []
    for svc, cls, state_of, other in (
        (p.port, FleetCoordinator, _worker_state, others[0]),
        (p.ref, RCoord, _ref_worker_state, others[1]),
    ):
        coord = cls(svc, cadence=8)
        w = coord.register()
        old_gen = svc.generation
        stale = state_of(svc.tree, p.records[:200])
        svc.swap(other)
        coord.submit(w, state=stale, generation=old_gen)
        rep = coord.fold()
        assert rep.stale_partials == 1 and not rep.published
        assert rep.n_records == 0
        assert coord.stats()["stale_dropped"] == 1
        reports.append((_report(rep), coord.stats()))
    assert reports[0] == reports[1]
    assert _digest(p.port.tree) == _digest(p.ref.tree)


def test_apply_partial_cas_rejects_superseded_live_version():
    """A swap between routing and fold makes ``apply_partial`` refuse the
    merged partial: neither the outgoing nor the new live tree changes."""
    p = Pair(15)
    svc = p.port
    live = svc.live_version()
    state = _worker_state(svc.tree, p.records)
    old_tree = svc.tree
    v0 = planlib.desc_version(old_tree)
    old_digest = _digest(old_tree)
    svc.swap(p.other_builds(42)[0])
    new_digest = _digest(svc.tree)
    assert svc.apply_partial(state, expected=live) is False
    assert planlib.desc_version(old_tree) == v0
    assert _digest(old_tree) == old_digest and _digest(svc.tree) == new_digest
    if svc.tree.n_leaves != old_tree.n_leaves:
        with pytest.raises(ValueError):
            svc.apply_partial(state)
    # the reference refuses the same partial the same way
    rlive = p.ref.live_version()
    p.ref.swap(p.other_builds(42)[1])
    assert p.ref.apply_partial(to_ref(state), expected=rlive) is False


def test_worker_join_and_leave_mid_stream():
    p = Pair(17)
    want = _single_stream_digest(p.port.tree, p.records)
    reports = []
    for svc, cls, state_of in ((p.port, FleetCoordinator, _worker_state),
                               (p.ref, RCoord, _ref_worker_state)):
        coord = cls(svc, cadence=8)
        a = coord.register("early")
        thirds = np.array_split(p.records, 3)
        coord.submit(a, state=state_of(svc.tree, thirds[0]))
        b = coord.register("late-joiner")
        assert {w.name for w in coord.workers()} == {"early", "late-joiner"}
        coord.submit(b, state=state_of(svc.tree, thirds[1]))
        coord.submit(a, state=state_of(svc.tree, thirds[2]))
        coord.leave(a)
        assert [w.name for w in coord.workers()] == ["late-joiner"]
        with pytest.raises(ValueError, match="unregistered"):
            coord.submit(a, state=state_of(svc.tree, thirds[0]))
        rep = coord.fold()
        assert rep.published and rep.n_partials == 3
        reports.append(_report(rep))
    assert reports[0] == reports[1]
    assert _digest(p.port.tree) == want == _digest(p.ref.tree)


def test_protocol_validation():
    p = Pair(19)
    svc = p.port
    with pytest.raises(ValueError, match="cadence"):
        FleetCoordinator(svc, cadence=0)
    coord = FleetCoordinator(svc, cadence=4)
    w = coord.register()
    with pytest.raises(ValueError, match="ShardState"):
        coord.submit(w)
    rows = p.records[:100]
    chunky = dataclasses.replace(
        _worker_state(svc.tree, rows), chunks={0: [(0, rows[:2])]})
    with pytest.raises(ValueError, match="aggregates, not rows"):
        coord.submit(w, state=chunky)
    assert isinstance(w, WorkerHandle) and w.worker_id == 1
    with pytest.raises(TypeError, match="record"):
        svc.ingest(iter([rows]), IngestOptions(coordinator=coord))
    assert FoldReport.__dataclass_fields__.keys() == {
        "fold", "n_partials", "n_records", "published", "stale_partials",
        "generation", "tracker_merges", "drift"}


# ---------------------------------------------------------------------------
# Section 5 of the hash-seed probe, on the port
# ---------------------------------------------------------------------------
_SECTION5 = """
import hashlib
import numpy as np

def digest(pkg):
    import importlib
    mod = lambda name: importlib.import_module(pkg + "." + name)
    FleetCoordinator = mod("coordinator").FleetCoordinator
    qry = mod("core.query")
    datagen, wl = mod("data.datagen"), mod("data.workload")
    engine, sharded, service = mod("engine"), mod("engine.sharded"), \\
        mod("service")
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    ekw = kw if pkg == "repro_torch" else {"backend": "numpy"}
    h = hashlib.sha256()
    schema5, records5 = datagen.make_tpch_like(1500, seed=5)
    work5, _ = wl.make_tpch_workload(schema5, n_per_template=2, seed=5)
    cuts5 = work5.candidate_cuts(max_adv=4)

    def worker_state(tree, rows):
        eng = engine.LayoutEngine(engine.replicate_tree(tree), **ekw)
        return sharded.ShardIngestor(eng, shard_id=0).run(
            sharded.micro_batches(rows, 97))

    for k, cadence, order_seed in ((1, 1, 0), (2, 1, 1), (4, 3, 2),
                                   (8, 5, 3)):
        svc = service.LayoutService(service.build_layout(
            records5[:700], work5, strategy="greedy", cuts=cuts5,
            min_block=40, seed=5, **kw), **ekw)
        coord = FleetCoordinator(svc, cadence=cadence)
        workers = [coord.register(f"w{i}") for i in range(min(k, 3))]
        states = [worker_state(svc.tree, p)
                  for p in np.array_split(records5, k)]
        for j, i in enumerate(
                np.random.default_rng(order_seed).permutation(k)):
            t = svc.workload_tracker()
            t.record(qry.Workload(
                schema5, work5.queries[int(i) % len(work5.queries):][:2]))
            coord.submit(workers[j % len(workers)], state=states[int(i)],
                         tracker_state=t.drain_state())
        if coord.stats()["pending"] or coord.stats()["pending_tracker"]:
            coord.fold()
        tree5 = svc.tree
        for arr in (tree5.leaf_lo, tree5.leaf_hi, tree5.leaf_cat,
                    tree5.leaf_adv):
            h.update(np.ascontiguousarray(arr).tobytes())
        h.update(repr(coord.tracker.snapshot().top_signatures(16)).encode())
    return h.hexdigest()
"""


def _port_section5(seed: int) -> str:
    env = {**os.environ, "PYTHONPATH": str(SRC),
           "PYTHONHASHSEED": str(seed)}
    out = subprocess.run(
        [sys.executable, "-c", _SECTION5 + "print(digest('repro_torch'))"],
        env=env, capture_output=True, text=True, check=True, timeout=300,
    )
    return out.stdout.strip().splitlines()[-1]


def test_coordinator_folds_are_hash_seed_independent():
    """The port's coordinator-cadence folds print one digest under two
    ``PYTHONHASHSEED`` values, and it is the reference's digest."""
    digests = {seed: _port_section5(seed) for seed in (0, 1)}
    assert len(set(digests.values())) == 1, digests
    scope: dict = {}
    exec(_SECTION5, scope)
    assert digests[0] == scope["digest"]("repro")
