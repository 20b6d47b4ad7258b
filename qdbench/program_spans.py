"""The program's own spans in a traced window, and the readers over them.

``repro_torch.tracing`` records spans inside the program (``ingest``, its
``open``, each batch's ``fold`` and ``fused_ingest.launch``, its
``close`` split into the copy back, the unpack, ``merge``, ``apply`` and
the report) as ``(name, start_ns, end_ns)`` on ``time.time_ns()``: the
harness's shape and clock (``spans.py``), and the clock the profiler
stamps its events on.  Over a 10 s traced window the profiler's host
stamps can stray from it by a tenth of a millisecond and its device stamps
from its host stamps by up to a millisecond (PERF.md §6), so a reader
compares a span with a device event only where the host leads the device
by more than that, as it does by milliseconds within a pass.  A traced run
starts the recorder right after the profiler and stops it where the traced
part ends; its spans then join the harness's in ``trace.reduce``, so
``Trace.idle_gaps`` names the innermost span of either kind, and the
readers below get them as ``obs.program_spans``.  Each reader returns
``None`` where there is nothing to read: no program spans (a program
without the recorder), no device events (a CPU run), no whole pass.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

from qdbench.trace import gaps, short

EDGES = ("ingest.open", "ingest.close")  # a pass's host edges
OUTSIDE = "outside the program's spans"
# folds a pass read for the host's cost: a pass's close drains the stream,
# so its first 32 batches queue at most 128 kernels, too few to fill the
# launch queue and make a fold wait for the device (PERF.md §5)
FIRST_FOLDS = 32


def _named(spans, name: str) -> list:
    return sorted((s, e) for n, s, e in spans if n == name)


def _passes(trace, spans) -> list:
    """The ``ingest`` spans that began and ended in the traced window."""
    return [(s, e) for s, e in _named(spans, "ingest")
            if trace.start_ns <= s and e <= trace.end_ns]


def pass_edge_idle_ms(obs):
    """``engine.pass_edge_idle_ms.ingest`` (ms): device-idle ms a pass in
    gaps that begin inside a pass's ``ingest.open`` or ``ingest.close`` (or
    a span inside them), over the ``ingest`` spans that began and ended in
    the traced window."""
    trace, spans = obs.trace, getattr(obs, "program_spans", None)
    if trace is None or not trace.device or not spans:
        return None
    passes = _passes(trace, spans)
    if not passes:
        return None
    edges = sorted(x for name in EDGES for x in _named(spans, name))
    starts = [s for s, _ in edges]
    idle = 0
    for a, b in gaps(trace.device, trace.start_ns, trace.end_ns):
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a < edges[i][1]:
            idle += b - a
    return idle / 1e6 / len(passes)


def _innermost(spans, lo: int, hi: int) -> list:
    """``[lo, hi)`` cut into ``(start, end, name)`` pieces, each named by
    the innermost span open over it (``OUTSIDE`` where none is)."""
    pieces, stack, cur = [], [], lo

    def upto(t):
        nonlocal cur
        if t > cur:
            pieces.append((cur, t, stack[-1][0] if stack else OUTSIDE))
            cur = t

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][1] <= s:
            upto(stack[-1][1])
            stack.pop()
        upto(s)
        stack.append((name, e))
    while stack:
        upto(stack[-1][1])
        stack.pop()
    upto(hi)
    return pieces


def idle_by_span(obs):
    """Device-idle ms a pass by where the host was: each idle nanosecond of
    the traced window goes to the innermost program span open at that
    nanosecond, over the ``ingest`` spans that began and ended in the
    window, the most first: ``{name: ms}``.  ``Trace.idle_gaps`` names a
    whole gap by where it began, which puts a pass's edge under the copy
    back that starts it; this splits the edge among the steps the host
    went through (PERF.md §5)."""
    trace, spans = obs.trace, getattr(obs, "program_spans", None)
    if trace is None or not trace.device or not spans:
        return None
    passes = _passes(trace, spans)
    if not passes:
        return None
    pieces = _innermost(spans, trace.start_ns, trace.end_ns)
    by, j = defaultdict(int), 0
    for a, b in gaps(trace.device, trace.start_ns, trace.end_ns):
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            s, e, name = pieces[k]
            by[name] += min(b, e) - max(a, s)
            k += 1
    return {name: ns / 1e6 / len(passes)
            for name, ns in sorted(by.items(), key=lambda kv: -kv[1])}


def fold_host_us(obs):
    """``engine.fold_host_us.ingest`` (us): the host's cost to hand one
    batch to the card, the median ``ingest.fold`` span of the first
    ``FIRST_FOLDS`` of each pass in the window.  Later in a pass that
    queues more kernels than the launch queue holds, a fold waits there
    for a slot, and its span reads the device's pace, not the host's."""
    spans = getattr(obs, "program_spans", None) or []
    folds = _named(spans, "ingest.fold")
    starts = [s for s, _ in folds]
    first = []
    for s, e in _named(spans, "ingest"):
        i = bisect.bisect_left(starts, s)
        first += [fe - fs for fs, fe in folds[i:i + FIRST_FOLDS] if fe <= e]
    return statistics.median(first) / 1e3 if first else None


def _kernels_a_launch(names: set):
    """The kernels one launch queues, where ``names`` are the kernels of
    one ``fused_ingest`` design (``fused_ingest.KERNEL_NAMES``); else
    None."""
    from repro_torch.kernels.fused_ingest import KERNEL_NAMES

    return next((len(design) for design in KERNEL_NAMES.values()
                 if set(design) == names), None)


def idle_queued_share(obs):
    """``device.idle_queued_share.ingest`` (%): the share of the traced
    window idle in gaps that end at a ``fused_ingest*`` kernel whose
    launch (the ``fused_ingest.launch`` span that queued it) had returned
    before the gap began: the work was queued, so the gap is the device's
    own.  The n-th kernel on the stream is the (n // k)-th launch's, k the
    kernels a launch of the trace's design queues (one, or the leafwise
    design's four).  Nothing is read if the trace kept other than k
    kernels a launch span."""
    trace, spans = obs.trace, getattr(obs, "program_spans", None)
    if trace is None or not trace.window_s or not spans:
        return None
    launches = _named(spans, "fused_ingest.launch")
    device = trace.device
    fused = sorted((i for i, (name, _, _) in enumerate(device)
                    if short(name).startswith("fused_ingest")),
                   key=lambda i: device[i][1])
    k = _kernels_a_launch({short(device[i][0]) for i in fused})
    if not launches or k is None or len(fused) != k * len(launches):
        return None
    # a gap ends where the next event starts: the launch by that start
    launch_of = {device[i][1]: launches[n // k] for n, i in enumerate(fused)}
    queued = sum(b - a for a, b in gaps(device, trace.start_ns, trace.end_ns)
                 if b in launch_of and launch_of[b][1] <= a)
    return 100.0 * queued / (trace.end_ns - trace.start_ns)
