"""The program's span recorder (``repro_torch.tracing``) and the spans of
``LayoutEngine.ingest``, on the CPU.

Off, ``span`` hands back one shared no-op object and nothing is kept; on,
spans nest on the clock, and an ingest records its open, its folds and each
step of its close, while its report and the tree it tightens stay what
they are with recording off.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.core.qdtree import FrozenQdTree, random_layout  # noqa: E402
from repro_torch.data.datagen import make_tpch_like  # noqa: E402
from repro_torch.data.workload import make_tpch_workload  # noqa: E402
from repro_torch.engine import LayoutEngine  # noqa: E402

LEAF_FIELDS = ("leaf_lo", "leaf_hi", "leaf_cat", "leaf_adv", "block_sizes")
CLOSE_STEPS = ("ingest.partial.copy", "ingest.partial.unpack",
               "ingest.merge", "ingest.apply", "ingest.report")


@pytest.fixture(autouse=True)
def _recording_off():
    yield
    tracing.stop()


def test_off_records_nothing_and_shares_one_noop():
    tracing.stop()
    a, b = tracing.span("x"), tracing.span("y")
    assert a is b is tracing.NOOP
    with a:
        with b:
            pass
    tracing.start()
    assert tracing.stop() == []


def _within(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_on_nests_names_parents_and_durations():
    tracing.start()
    t0 = tracing.now_ns()
    with tracing.span("outer"):
        with tracing.span("inner"):
            time.sleep(0.002)
        with tracing.span("second"):
            pass
    with tracing.span("after"):
        pass
    t1 = tracing.now_ns()
    spans = tracing.stop()
    # in the order they closed, each within its parent's interval
    assert [s[0] for s in spans] == ["inner", "second", "outer", "after"]
    by = {s[0]: s for s in spans}
    for name, start, end in spans:
        assert t0 <= start <= end <= t1
    assert _within(by["inner"], by["outer"])
    assert _within(by["second"], by["outer"])
    assert by["inner"][2] <= by["second"][1]
    assert by["outer"][2] <= by["after"][1]
    assert by["inner"][2] - by["inner"][1] >= 2_000_000
    with tracing.span("late"):  # recording is off again
        pass
    tracing.start()
    assert tracing.stop() == []


def test_two_threads_keep_their_own_stacks():
    tracing.start()
    ready = threading.Barrier(2, timeout=10)

    def work(tag):
        with tracing.span(f"{tag}.outer"):
            ready.wait()  # both outers are open at once
            with tracing.span(f"{tag}.inner"):
                ready.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    spans = tracing.stop()
    assert sorted(s[0] for s in spans) == [
        "a.inner", "a.outer", "b.inner", "b.outer"]
    by = {s[0]: s for s in spans}
    for tag in "ab":
        assert _within(by[f"{tag}.inner"], by[f"{tag}.outer"])
    # the two threads' spans overlap: each kept its own
    assert by["a.outer"][1] < by["b.outer"][2]
    assert by["b.outer"][1] < by["a.outer"][2]


def _case(seed=0, n_leaves=24):
    schema, sample = make_tpch_like(4 * n_leaves, seed=seed)
    work, _ = make_tpch_workload(schema, n_per_template=2, seed=seed)
    frozen = random_layout(work.candidate_cuts(), sample, n_leaves, seed)
    return frozen, make_tpch_like(3000, seed=seed + 1)[1]


def _fresh(frozen):
    return FrozenQdTree.from_arrays(frozen.to_arrays())


def _batches(records):
    # three batches, one of them empty
    return [records[:1700], records[:0], records[1700:]]


def test_cpu_ingest_records_its_open_folds_and_close():
    frozen, records = _case()
    eng = LayoutEngine(_fresh(frozen), device="cpu")
    tracing.start()
    eng.ingest([torch.from_numpy(b) for b in _batches(records)])
    spans = tracing.stop()
    names = [s[0] for s in spans]
    want = {"ingest": 1, "ingest.open": 1, "ingest.plan": 1,
            "ingest.accumulator": 1, "ingest.fold": 2, "ingest.close": 1,
            **{k: 1 for k in CLOSE_STEPS}}
    assert {n: names.count(n) for n in set(names)} == want
    assert "fused_ingest.launch" not in names  # the plain version ran

    by = {n: spans[names.index(n)] for n in set(names) if names.count(n) == 1}
    folds = [s for s in spans if s[0] == "ingest.fold"]
    for part in (by["ingest.open"], by["ingest.close"], *folds):
        assert _within(part, by["ingest"])
    for name in ("ingest.plan", "ingest.accumulator"):
        assert _within(by[name], by["ingest.open"])
    for step in CLOSE_STEPS:
        assert _within(by[step], by["ingest.close"]), step
    assert by["ingest.open"][2] <= folds[0][1]
    assert folds[-1][2] <= by["ingest.close"][1]


def test_report_and_tree_are_the_same_with_recording_on_and_off():
    frozen, records = _case(seed=3)
    out = []
    for on in (False, True):
        tree = _fresh(frozen)
        if on:
            tracing.start()
        report = LayoutEngine(tree, device="cpu").ingest(
            [torch.from_numpy(b) for b in _batches(records)])
        assert bool(tracing.stop()) is on
        out.append((report, tree))
    (r0, t0), (r1, t1) = out
    a, b = dataclasses.asdict(r0), dataclasses.asdict(r1)
    a.pop("wall_s"), b.pop("wall_s")
    np.testing.assert_array_equal(a.pop("block_sizes"), b.pop("block_sizes"))
    assert a == b
    for field in LEAF_FIELDS:
        x, y = getattr(t0, field), getattr(t1, field)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
