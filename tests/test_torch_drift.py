"""The port's drift layer against ``repro.service.drift`` on the CPU.

The monitor's decisions, the per-batch ingest observations and a whole
drift-triggered rebuild (``executor="sync"``) equal the reference's.  The
device form of the observation probe (per-leaf counts as an int64 tensor,
block ids kept where the fold made them) equals the host probe.  The
reference's thread hammers on the rebuilder are kept.
"""

import dataclasses
import pickle
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.engine import LayoutEngine as RefEngine  # noqa: E402
from repro.service import DriftConfig as RConfig  # noqa: E402
from repro.service import DriftMonitor as RMonitor  # noqa: E402
from repro.service import IngestOptions as RIngestOptions  # noqa: E402
from repro.service import LayoutService as RefService  # noqa: E402
from repro.service import RebuildPolicy as RPolicy  # noqa: E402
from repro.service import build_layout as rbuild_layout  # noqa: E402
from repro_torch.engine import LayoutEngine  # noqa: E402
from repro_torch.engine import WindowStat  # noqa: E402
from repro_torch.engine import backends as tbe  # noqa: E402
from repro_torch.service import (  # noqa: E402
    AutoRebuilder,
    DriftConfig,
    DriftMonitor,
    IngestOptions,
    LayoutService,
    RebuildPolicy,
    RecordReservoir,
    build_layout,
)
from tests.test_drift import _drift_setup  # noqa: E402
from tests.test_torch_engine import _arrays  # noqa: E402
from tests.test_torch_woodblock import to_port  # noqa: E402

CONFIGS = [
    dict(window=4, min_fill=1, abs_threshold=0.5, rel_degradation=None,
         hysteresis=2, cooldown=3),
    dict(window=3, min_fill=2, abs_threshold=None, rel_degradation=0.5,
         hysteresis=1, cooldown=2),
    dict(window=5, min_fill=3, abs_threshold=0.6, rel_degradation=0.3,
         hysteresis=2, cooldown=0),
]


def _stat(scanned: int, capacity: int) -> WindowStat:
    return WindowStat(scanned_tuples=scanned, capacity=capacity,
                      n_records=capacity)


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
def test_monitor_decisions_match_repro(cfg):
    from repro.engine import WindowStat as RStat

    ref = RMonitor(RConfig(**CONFIGS[cfg]))
    port = DriftMonitor(DriftConfig(**CONFIGS[cfg]))
    rng = np.random.default_rng(cfg)
    for i in range(120):
        cap = int(rng.integers(1, 1000))
        s = int(rng.integers(0, cap + 1))
        want = ref.observe(RStat(s, cap, cap))
        got = port.observe(_stat(s, cap))
        assert dataclasses.asdict(got) == pytest.approx(
            dataclasses.asdict(want), nan_ok=True), i
        if i % 37 == 36:
            ref.rebaseline()
            port.rebaseline()
    assert port.window_stat.to_array().tolist() == [
        ref.window_stat.scanned_tuples, ref.window_stat.capacity,
        ref.window_stat.n_records]


def _engines(seed):
    records, work_a, _ = _drift_setup(seed)
    build = rbuild_layout(records, work_a, min_block=150)
    port_build = build_layout(records, to_port(work_a), min_block=150,
                              device="cpu")
    np.testing.assert_array_equal(port_build.bids, build.bids)
    return (records, work_a, RefEngine(build.tree, backend="numpy"),
            LayoutEngine(port_build.tree, device="cpu"))


def _batches(records, step=97):
    return [records[s:s + step] for s in range(0, records.shape[0], step)]


def test_ingest_observation_matches_repro():
    records, work_a, ref, eng = _engines(3)
    want, got = [], []
    r_rep = ref.ingest(_batches(records), observe=work_a,
                       on_observation=want.append)
    t_rep = eng.ingest(_batches(records), observe=to_port(work_a),
                       on_observation=got.append)
    assert [dataclasses.astuple(s) for s in got] == [
        dataclasses.astuple(s) for s in want]
    assert dataclasses.astuple(t_rep.observation) == dataclasses.astuple(
        r_rep.observation)
    np.testing.assert_array_equal(t_rep.block_sizes, r_rep.block_sizes)
    assert eng.ingest([records[:100]]).observation is None


def test_device_probe_equals_host_probe(monkeypatch):
    """A probe with its per-leaf counts as an int64 tensor scores block
    ids where the fold left them (here the CPU stands in for the card):
    every batch's WindowStat equals the host probe's."""
    records, work_a, _, eng = _engines(5)
    host = eng.observation_probe(to_port(work_a))
    assert host.on_device is None  # an engine on the CPU keeps numpy
    assert host.per_leaf.dtype == np.int64
    assert eng.observation_probe(host) is host
    dev = dataclasses.replace(
        host, on_device=torch.from_numpy(host.per_leaf.copy()))
    bids = eng.route(records)
    assert dev.observe(torch.from_numpy(bids)) == host.observe(bids)
    with pytest.raises(ValueError, match="no per-leaf counts"):
        host.observe(torch.from_numpy(bids))

    asked = []
    orig = tbe.DeviceAccumulator.fold

    def spy(self, records, return_bids=False, on_device=False):
        asked.append(on_device)
        return orig(self, records, return_bids, on_device)

    monkeypatch.setattr(tbe.DeviceAccumulator, "fold", spy)
    seen_dev, seen_host = [], []
    eng.ingest(_batches(records), observe=dev,
               on_observation=seen_dev.append)
    assert asked and all(asked)
    asked.clear()
    eng.ingest(_batches(records), observe=host,
               on_observation=seen_host.append)
    assert asked and not any(asked)
    assert seen_dev == seen_host
    # pickling (process shards) keeps only the host form
    back = pickle.loads(pickle.dumps(dev))
    assert back.on_device is None and back.n_queries == host.n_queries
    np.testing.assert_array_equal(back.per_leaf, host.per_leaf)


def test_reservoir_tensor_batches_equal_numpy_batches():
    rng = np.random.default_rng(0)
    a, b = RecordReservoir(50), RecordReservoir(50)
    for n in (7, 30, 0, 64, 3, 120, 11):
        rows = rng.integers(0, 100, (n, 3)).astype(np.int32)
        a.add(rows)
        b.add(torch.from_numpy(rows))
        np.testing.assert_array_equal(b.snapshot(), a.snapshot())
        assert len(a) == len(b) and a.records_seen == b.records_seen


def _shift_scenario(make_service, ingest_options, policy, workloads,
                    records):
    svc = make_service()
    work_a, work_b = workloads
    gen0 = svc.generation
    with svc.auto_rebuilder(policy(work_a)) as rebuilder:
        def batches(rs):
            for s in range(0, rs.shape[0], 500):
                yield rs[s:s + 500]

        rep_a = svc.ingest(batches(records[:3000]),
                           ingest_options(rebuilder))
        rebuilder.set_workload(work_b)
        svc.ingest(batches(records[3000:]), ingest_options(rebuilder))
    return svc, gen0, rep_a, rebuilder


def test_auto_rebuilder_recovers_from_workload_shift_like_repro():
    records, work_a, work_b = _drift_setup(7)
    drift = dict(window=4, min_fill=2, abs_threshold=0.5,
                 rel_degradation=None, hysteresis=2, cooldown=4)

    def policy(cls_policy, cls_config):
        return lambda w: cls_policy(
            workload=w, drift=cls_config(**drift), reservoir_capacity=4000,
            executor="sync", rebuild_kw=dict(min_block=100))

    ref = _shift_scenario(
        lambda: RefService.build(records[:2000], work_a, strategy="greedy",
                                 backend="numpy", min_block=100),
        lambda rb: RIngestOptions(monitor=rb),
        policy(RPolicy, RConfig), (work_a, work_b), records)
    twa, twb = to_port(work_a), to_port(work_b)
    port = _shift_scenario(
        lambda: LayoutService.build(records[:2000], twa, strategy="greedy",
                                    device="cpu", min_block=100),
        lambda rb: IngestOptions(monitor=rb),
        policy(RebuildPolicy, DriftConfig), (twa, twb), records)
    (rsvc, rgen0, rrep, rrb), (tsvc, tgen0, trep, trb) = ref, port
    assert dataclasses.astuple(trep.observation) == dataclasses.astuple(
        rrep.observation)
    assert trb.rebuilds_deployed == rrb.rebuilds_deployed == 1
    assert len(trb.events) == len(rrb.events)
    for te, re_ in zip(trb.events, rrb.events):
        assert (te.observation, te.deployed, te.skipped, te.error) == (
            re_.observation, re_.deployed, re_.skipped, re_.error)
        assert dataclasses.asdict(te.decision) == dataclasses.asdict(
            re_.decision)
    assert tsvc.generation == rsvc.generation > tgen0 == rgen0
    want, got = _arrays(rsvc.tree), tsvc.tree.to_arrays()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    assert tsvc.skip_stats(records, twb, tighten=False).scanned_tuples == (
        rsvc.skip_stats(records, work_b, tighten=False).scanned_tuples)
    np.testing.assert_array_equal(trb.reservoir.snapshot(),
                                  rrb.reservoir.snapshot())


def test_auto_rebuilder_single_inflight_and_skip_events():
    gate = threading.Event()
    calls = []

    def slow_rebuild(records, workload, **kw):
        calls.append(threading.get_ident())
        assert gate.wait(10)
        return types.SimpleNamespace(swapped=True)

    rebuilder = AutoRebuilder(
        types.SimpleNamespace(rebuild=slow_rebuild), workload=None,
        config=DriftConfig(window=1, min_fill=1, abs_threshold=0.1,
                           rel_degradation=None, hysteresis=1, cooldown=0),
        reservoir_capacity=8,
    )
    rebuilder.add_records(torch.ones((4, 2), dtype=torch.int32))
    bad = _stat(100, 100)
    with ThreadPoolExecutor(max_workers=4) as pool:
        for f in [pool.submit(rebuilder.observe, bad) for _ in range(8)]:
            f.result()
        gate.set()
        rebuilder.drain(timeout=10)
    rebuilder.close()
    assert len(calls) == 1
    deployed = [e for e in rebuilder.events if e.deployed]
    skipped = [e for e in rebuilder.events if e.skipped == "in_flight"]
    assert len(deployed) == 1
    assert len(deployed) + len(skipped) == len(rebuilder.events) >= 2


def test_auto_rebuilder_on_event_may_reenter_the_rebuilder():
    reentered = []

    def on_event(ev):
        assert rebuilder.drain(timeout=5)
        rebuilder.observe(_stat(0, 100))
        reentered.append(ev)

    rebuilder = AutoRebuilder(
        types.SimpleNamespace(
            rebuild=lambda *a, **k: types.SimpleNamespace(swapped=True)
        ),
        workload=None,
        config=DriftConfig(window=2, min_fill=1, abs_threshold=0.5,
                           rel_degradation=None, hysteresis=1, cooldown=0),
        executor="sync",
        on_event=on_event,
    )
    rebuilder.add_records(np.ones((4, 2), np.int32))
    done = []
    t = threading.Thread(
        target=lambda: done.append(rebuilder.observe(_stat(100, 100))))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "on_event callback deadlocked the rebuilder"
    assert len(reentered) == 1 and done[0].triggered
    rebuilder.close()


def test_auto_rebuilder_surfaces_errors_and_empty_reservoir():
    def boom(records, workload, **kw):
        raise RuntimeError("builder exploded")

    rebuilder = AutoRebuilder(
        types.SimpleNamespace(rebuild=boom), workload=None,
        config=DriftConfig(window=1, min_fill=1, abs_threshold=0.1,
                           rel_degradation=None, hysteresis=1, cooldown=0),
        executor="sync",
    )
    rebuilder.observe(_stat(100, 100))
    assert rebuilder.events[-1].skipped == "empty_reservoir"
    rebuilder.add_records(np.ones((4, 2), np.int32))
    rebuilder.observe(_stat(100, 100))
    ev = rebuilder.events[-1]
    assert "RuntimeError: builder exploded" in ev.error and not ev.deployed
    rebuilder.close()
