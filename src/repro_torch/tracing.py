"""In-memory host spans of the program's own boundaries.

    tracing.start()
    with tracing.span("ingest.fold"):
        ...
    spans = tracing.stop()  # [(name, start_ns, end_ns)]

Off unless :func:`start` was called: :func:`span` then returns one shared
no-op object after one check of a module global, reading no clock and
allocating nothing.  On, each span appends one tuple to a list when it
exits.  Spans nest as the calls that open them do; a reader finds a span's
parent by containment on the clock.  There is no exporter: the caller that
started the recording reads the list :func:`stop` returns.

The clock is :func:`now_ns`, ``time.time_ns()``: the clock
``torch.profiler`` stamps its events on, so a span can be laid beside the
device's timeline, as closely as the profiler's stamps keep to that clock
(its host-side events within microseconds of the spans in a short
session; its device stamps up to a millisecond off over a 10 s one,
PERF.md §6).
"""

from __future__ import annotations

import time

_on = False
_done: list = []  # (name, start_ns, end_ns), in the order they closed


def now_ns() -> int:
    """The spans' clock: nanoseconds since the epoch."""
    return time.time_ns()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Open:
    __slots__ = ("name", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.start = now_ns()
        return self

    def __exit__(self, *exc):
        end = now_ns()
        if _on:
            _done.append((self.name, self.start, end))
        return False


def span(name: str):
    """A context manager that records ``name`` from its entry to its exit
    while recording is on; the shared no-op object while it is off."""
    if not _on:
        return NOOP
    return _Open(name)


def start() -> None:
    """Start recording, with no span kept from before."""
    global _on
    _done.clear()
    _on = True


def stop() -> list[tuple]:
    """Stop recording; the spans that closed while it was on, as
    ``(name, start_ns, end_ns)`` in the order they closed."""
    global _on
    _on = False
    done = list(_done)
    _done.clear()
    return done
