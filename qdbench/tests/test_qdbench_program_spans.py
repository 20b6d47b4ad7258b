"""The readers of the program's spans (``program_spans.py``) on hand-made
traces, and a traced CPU run of a cell with the program's recorder on
beside the profiler, its spans handed to ``trace.reduce``."""

import types

import pytest
import torch

from qdbench import program_spans as ps
from qdbench import run, trace

SHARED = "void fused_ingest_shared(Ingest, Acc)"
LEAFWISE = [f"void fused_ingest_leafwise_{k}(Ingest, Acc)"
            for k in ("route", "scan", "scatter")] + [
    "void fused_ingest_leafwise_fold<2>(Ingest, Acc, long long const*)"]


def obs(device, spans, start=0, end=1000):
    busy = trace.union_ns([(s, e) for _, s, e in device]) / 1e9
    t = trace.Trace(start_ns=start, end_ns=end, busy_s=busy, device=device,
                    spans=list(spans))
    return types.SimpleNamespace(trace=t, program_spans=spans)


def span(name, s, e):
    return (name, s, e)


def idle_share(o):
    return 100.0 * (1 - o.trace.busy_s / o.trace.window_s)


# three batches of the shared kernel: the window opens idle before the
# first (its launch returned after the gap began); the second's launch had
# returned 70 ns before the gap (queued); the third's began inside its gap
# (the host was late)
SHARED_CASE = ([(SHARED, 10, 100), (SHARED, 130, 200), (SHARED, 250, 400)],
               [span("fused_ingest.launch", 0, 5),
                span("fused_ingest.launch", 20, 30),
                span("fused_ingest.launch", 220, 240)])


def test_a_gap_after_its_launch_returned_is_queued():
    o = obs(*SHARED_CASE)
    assert ps.idle_queued_share(o) == pytest.approx(3.0)  # 30 of 1000 ns
    assert ps.idle_queued_share(o) <= idle_share(o)


def test_a_gap_its_launch_came_inside_is_the_hosts():
    device, spans = SHARED_CASE
    late = spans[:1] + [span("fused_ingest.launch", 110, 120), spans[2]]
    assert ps.idle_queued_share(obs(device, late)) == 0.0
    # a launch still running when the device went idle: not yet queued
    straddle = spans[:1] + [span("fused_ingest.launch", 90, 105), spans[2]]
    assert ps.idle_queued_share(obs(device, straddle)) == 0.0


def test_the_leafwise_designs_four_kernels_share_one_launch():
    # two launches of four kernels; the second launch returned before the
    # device finished the first's fold, so its gaps are all queued
    device = [(name, s, s + 20) for name, s in
              zip(LEAFWISE * 2, (100, 125, 130, 160, 200, 230, 240, 270))]
    spans = [span("fused_ingest.launch", 50, 90),
             span("fused_ingest.launch", 95, 150)]
    # gaps inside launch 0 (120-125, 150-160) and at launch 1 (180-200,
    # 220-230, 260-270) are queued; the window's edges are not
    o = obs(device, spans)
    assert ps.idle_queued_share(o) == pytest.approx(100 * 55 / 1000)
    assert ps.idle_queued_share(o) <= idle_share(o)


def test_dropped_kernel_events_read_none():
    device, spans = SHARED_CASE
    assert ps.idle_queued_share(obs(device[1:], spans)) is None
    leafwise = [(n, 100 + 30 * i, 120 + 30 * i)
                for i, n in enumerate(LEAFWISE)]
    one = [span("fused_ingest.launch", 50, 90)]
    assert ps.idle_queued_share(obs(leafwise, one)) is not None
    assert ps.idle_queued_share(obs(leafwise[:3], one)) is None
    assert ps.idle_queued_share(obs(leafwise[1:], one)) is None
    assert ps.idle_queued_share(obs([], one)) is None


def pass_spans(s0, e0):
    """One ingest pass from ``s0`` to ``e0``: open, a fold, close with a
    copy back inside it."""
    return [span("ingest", s0, e0),
            span("ingest.open", s0, s0 + 40),
            span("ingest.fold", s0 + 40, s0 + 60),
            span("ingest.close", e0 - 100, e0),
            span("ingest.partial.copy", e0 - 90, e0 - 60)]


def test_pass_edge_idle_counts_gaps_begun_in_open_or_close():
    spans = pass_spans(0, 400) + pass_spans(400, 800)
    device = [("Memset", 10, 30),
              (SHARED, 50, 310),
              ("Memcpy DtoH", 330, 335),
              (SHARED, 520, 700)]
    o = obs(device, spans)
    # gaps 0-10 and 30-50 begin in the first open, 310-330 and 335-520 in
    # its close (its copy back), 700-1000 in the second close
    want = (10 + 20 + 20 + 185 + 300) / 1e6 / 2
    assert ps.pass_edge_idle_ms(o) == pytest.approx(want)
    # the breakdown names the innermost span of either kind
    o.trace.spans += [("batch", 25, 70)]
    gaps = dict(o.trace.idle_gaps())
    assert gaps == pytest.approx({
        "ingest.open": 10e-9, "batch": 20e-9,
        "ingest.partial.copy": 205e-9, "ingest.close": 300e-9})


def test_no_whole_pass_in_the_window_reads_none():
    device = [(SHARED, 50, 310)]
    assert ps.pass_edge_idle_ms(obs(device, pass_spans(0, 1200))) is None
    assert ps.pass_edge_idle_ms(obs(device, [])) is None
    assert ps.pass_edge_idle_ms(obs([], pass_spans(0, 400))) is None


def test_idle_by_span_splits_each_gap_by_the_innermost_span():
    spans = pass_spans(0, 400) + pass_spans(400, 800)
    device = [("Memset", 10, 30),
              (SHARED, 50, 310),
              ("Memcpy DtoH", 330, 335),
              (SHARED, 520, 700)]
    got = ps.idle_by_span(obs(device, spans))
    # 0-10 and 30-40 in the first open, 40-50 in its fold; 310-330 and
    # 335-340 in its copy back, 340-400 in its close; 400-440 in the second
    # open, 440-460 its fold, 460-520 the pass between them; 700-710 the
    # second close, 710-740 its copy, 740-800 its close; 800-1000 outside
    # any span.  Two passes.
    assert got == pytest.approx({
        "ingest.open": 60 / 2e6, "ingest.fold": 30 / 2e6,
        "ingest.close": 130 / 2e6, "ingest.partial.copy": 55 / 2e6,
        "ingest": 60 / 2e6, ps.OUTSIDE: 200 / 2e6})
    assert list(got)[0] == ps.OUTSIDE  # the most first
    # every idle nanosecond goes to exactly one span
    idle = sum(b - a for a, b in trace.gaps(device, 0, 1000))
    assert sum(got.values()) == pytest.approx(idle / 2e6)
    assert ps.idle_by_span(obs(device, pass_spans(0, 1200))) is None
    assert ps.idle_by_span(obs([], spans)) is None
    assert ps.idle_by_span(obs(device, [])) is None


def test_fold_host_us_is_the_median_fold():
    spans = [span("ingest.fold", 0, 3000), span("ingest.fold", 5000, 9000),
             span("ingest.fold", 10_000, 10_500), span("ingest", 0, 20_000)]
    assert ps.fold_host_us(obs([], spans)) == pytest.approx(3.0)
    assert ps.fold_host_us(obs([], [])) is None
    assert ps.fold_host_us(types.SimpleNamespace(trace=None)) is None
    # folds with no whole pass around them are not read
    assert ps.fold_host_us(obs([], spans[:3])) is None


def test_fold_host_us_reads_the_first_folds_of_each_pass():
    # past its first FIRST_FOLDS a pass's folds wait in a full launch
    # queue (200 ns here); its first ones (10 and 30 ns) are the host's
    n = ps.FIRST_FOLDS
    spans = []
    for p, cost in enumerate((10, 30)):
        t0 = p * 1_000_000
        spans.append(span("ingest", t0, t0 + 900_000))
        spans += [span("ingest.fold", t0 + 1000 * i,
                       t0 + 1000 * i + (cost if i < n else 200))
                  for i in range(3 * n)]
    # n folds of 10 ns and n of 30: the median is their midpoint
    assert ps.fold_host_us(obs([], spans)) == pytest.approx(0.020)


def test_a_traced_cpu_run_hands_on_the_programs_spans(monkeypatch):
    from repro_torch import tracing as program_tracing

    got = {}

    class Profile(torch.profiler.profile):
        """The profiler, with the program's recorder started right after
        it and stopped where the traced part ends."""

        def start(self):
            super().start()
            program_tracing.start()

        def stop(self):
            got["spans"] = program_tracing.stop()
            super().stop()

    def reduce(prof, start_ns, end_ns, spans):
        got["trace"] = trace.reduce(prof, start_ns, end_ns,
                                    spans + got["spans"])
        return got["trace"]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(run, "tracing", types.SimpleNamespace(reduce=reduce))
    result = run.run_cell(
        run.load_benchmark(), "tpch-sf100-b600k.bulk", 2**31 + 5, 0.05,
        traced=True, device="cpu",
        sizes={"resident_rows": 2048, "batch_rows": 1024, "pass_rows": 2500})
    assert result["correct"], result["checks"]
    o = types.SimpleNamespace(trace=got["trace"], program_spans=got["spans"])
    names = {s[0] for s in got["spans"]}
    assert {"ingest", "ingest.open", "ingest.fold", "ingest.close",
            "ingest.merge"} <= names
    fold_us = ps.fold_host_us(o)
    print("engine.fold_host_us.ingest", fold_us)
    assert fold_us > 0
    # no device events on the CPU: the device's readers have nothing
    assert ps.pass_edge_idle_ms(o) is None
    assert ps.idle_queued_share(o) is None
