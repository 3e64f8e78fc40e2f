"""MetricsRegistry: counters, gauges, and fixed-bucket histograms.

The registry is the scalar side of the observability plane (the tracer is
the temporal side): cheap thread-safe accumulation, snapshot-able per
round, dumped whole by the flight recorder.  Histograms use *fixed*
bucket edges declared at first observation — no dynamic rebinning, so an
``observe`` is one bisect + one increment and snapshots are directly
comparable across rounds.
"""

from __future__ import annotations

import threading
from bisect import bisect_right

__all__ = ["MetricsRegistry", "DEFAULT_EDGES"]

# Seconds-scale latency edges: 1ms .. 30s, roughly x3 per bucket.
DEFAULT_EDGES = (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0)


class _Hist:
    __slots__ = ("edges", "counts", "n", "total")

    def __init__(self, edges):
        self.edges = tuple(float(e) for e in edges)
        if list(self.edges) != sorted(set(self.edges)):
            raise ValueError("histogram edges must be strictly increasing")
        self.counts = [0] * (len(self.edges) + 1)
        self.n = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        self.counts[bisect_right(self.edges, value)] += 1
        self.n += 1
        self.total += value


class MetricsRegistry:
    """Named counters / gauges / histograms behind one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _Hist] = {}

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float, *, edges=DEFAULT_EDGES):
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Hist(edges)
            h.observe(float(value))

    def snapshot(self) -> dict:
        """A JSON-safe deep copy of every metric's current state."""
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    name: {"edges": list(h.edges),
                           "counts": list(h.counts),
                           "n": h.n, "sum": h.total}
                    for name, h in self._hists.items()},
            }
