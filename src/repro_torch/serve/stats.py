"""Latency and throughput accounting for the serving tier.

The recorder keeps raw per-request latencies (float seconds) so the
benchmark can report exact empirical percentiles rather than histogram
approximations; serving volumes here are small enough (≤ millions of
requests per run) that a flat float64 buffer is the simplest correct
thing.  Timings are *never* pinned by a test — only counters are — so
this module's outputs are reported, not gated on.
"""

from __future__ import annotations

import threading

import numpy as np


class LatencyRecorder:
    """Thread-safe append-only latency sample buffer with percentiles."""

    def __init__(self):
        self._lock = threading.Lock()
        self._samples: list[float] = []  # guarded by: self._lock

    def record(self, latency_s: float) -> None:
        with self._lock:
            self._samples.append(float(latency_s))

    def extend(self, latencies_s) -> None:
        with self._lock:
            self._samples.extend(float(v) for v in latencies_s)

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            return float(np.percentile(np.asarray(self._samples), q))

    def summary(self) -> dict:
        """count/mean/p50/p90/p99/max in milliseconds (0s when empty)."""
        with self._lock:
            if not self._samples:
                return {
                    "count": 0,
                    "mean_ms": 0.0,
                    "p50_ms": 0.0,
                    "p90_ms": 0.0,
                    "p99_ms": 0.0,
                    "max_ms": 0.0,
                }
            arr = np.asarray(self._samples)
        p50, p90, p99 = np.percentile(arr, (50, 90, 99))
        return {
            "count": int(arr.size),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(p50 * 1e3),
            "p90_ms": float(p90 * 1e3),
            "p99_ms": float(p99 * 1e3),
            "max_ms": float(arr.max() * 1e3),
        }


__all__ = ["LatencyRecorder"]
