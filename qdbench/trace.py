"""Reduce a ``torch.profiler`` trace of the window to what the readers use.

The profiler records the device only (kernels, copies, fills): recording
the host's every operator would slow the host path this benchmark
measures.  The host side is the harness's own spans (:mod:`qdbench.spans`),
on the same clock.  From them: the seconds in which anything ran on the
device (the union of its events), each kernel's device seconds by name,
and the idle stretches of the window, each named by the innermost harness
span the host was in when it began.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict

TOP = 10  # entries of each list of the breakdown
LOOKBACK = 256  # spans opened before a gap searched for the one it is in


@dataclasses.dataclass
class Trace:
    start_ns: int  # the traced window, on the profiler's clock
    end_ns: int
    busy_s: float  # union of device events
    device: list  # (name, start_ns, end_ns) of each device event
    spans: list  # (name, start_ns, end_ns) of each harness span

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def kernel_seconds(self, needle: str) -> tuple[float, int]:
        """Device seconds and count of the events whose name holds
        ``needle``."""
        total, n = 0, 0
        for name, s, e in self.device:
            if needle in name:
                total += e - s
                n += 1
        return total / 1e9, n

    def device_ops(self) -> list:
        """The device operations that took most time: [name, seconds]."""
        by = defaultdict(int)
        for name, s, e in self.device:
            by[short(name)] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[k, v / 1e9] for k, v in top]

    def idle_gaps(self) -> list:
        """Idle device seconds by what the host was doing when each gap
        began (the innermost harness span; "between passes" where none
        was open), the largest first: [name, seconds]."""
        spans = sorted(self.spans, key=lambda x: x[1])
        starts = [s for _, s, _ in spans]
        by = defaultdict(int)
        for a, b in gaps(self.device, self.start_ns, self.end_ns):
            i = bisect.bisect_right(starts, a)
            label, best = "between passes", None
            for name, s, e in spans[max(0, i - LOOKBACK):i]:
                if s <= a < e and (best is None or s >= best):
                    label, best = name, s
            by[label] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[k, v / 1e9] for k, v in top]


def short(name: str) -> str:
    """A kernel's name without its namespace, template arguments and
    parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.removeprefix("void ")
    return re.split(r"[(<]", name, maxsplit=1)[0].strip()[:96] or name[:96]


def union_ns(intervals) -> int:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def gaps(device, start: int, stop: int) -> list:
    """(start, end) of each stretch of [start, stop) with no device
    event."""
    out, end = [], start
    for _, s, e in sorted(device, key=lambda x: x[1]):
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if stop > end:
        out.append((end, stop))
    return out


def reduce(prof, start_ns: int, end_ns: int, spans: list) -> Trace:
    """The trace of a stopped ``torch.profiler.profile`` whose window ran
    from ``start_ns`` to ``end_ns`` (``time.time_ns()``, the profiler's
    clock), with the harness's ``spans`` of it; device events are clipped
    to the window."""
    device = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name != "CUDA":
            continue
        s = ev.start_ns()
        s, e = max(s, start_ns), min(s + ev.duration_ns(), end_ns)
        if e > s:
            device.append((ev.name(), s, e))
    busy = union_ns([(s, e) for _, s, e in device]) / 1e9
    return Trace(start_ns=start_ns, end_ns=end_ns, busy_s=busy,
                 device=device, spans=list(spans))
