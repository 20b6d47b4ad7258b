"""Host spans the harness records around its calls into the program.

Every span is kept as host seconds (``time.perf_counter``).  While
``intervals`` is on (a traced window), each is also kept as ``(name,
start_ns, end_ns)`` on ``time.time_ns()``, the clock of the profiler's
events, so the trace can say what the host was doing while the device sat
idle.  Spans come from the benchmark's own files only: the program's entry
points are wrapped, never edited.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Recorder:
    """Host spans by name, and the batches handed to the entry."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = defaultdict(list)
        self.intervals: list | None = None  # a list while a trace runs
        self.batches_handed = 0
        self._asked = self._done = None  # the entry's first and last asks

    @contextlib.contextmanager
    def span(self, name: str):
        t0, n0 = time.perf_counter(), time.time_ns()
        yield
        self.seconds[name].append(time.perf_counter() - t0)
        if self.intervals is not None:
            self.intervals.append((name, n0, time.time_ns()))

    def batches(self, batches):
        """Hand ``batches`` to the entry one at a time.  ``batch`` spans
        the entry's work on each, from the hand-off to its asking for the
        next (the last one's ends when the entry asks past the end)."""
        self._asked = (time.perf_counter(), time.time_ns())
        for batch in batches:
            self.batches_handed += 1
            with self.span("batch"):
                yield batch
        self._done = (time.perf_counter(), time.time_ns())

    @contextlib.contextmanager
    def entry_pass(self):
        """One call of the entry over every batch: a ``pass`` span, split
        into ``open`` (from the call to the entry's asking for the first
        batch) and ``close`` (from its asking past the last to the
        return), around the ``batch`` spans."""
        start = (time.perf_counter(), time.time_ns())
        yield
        end = (time.perf_counter(), time.time_ns())
        for name, (a, na), (b, nb) in (("pass", start, end),
                                       ("open", start, self._asked),
                                       ("close", self._done, end)):
            self.seconds[name].append(b - a)
            if self.intervals is not None:
                self.intervals.append((name, na, nb))
