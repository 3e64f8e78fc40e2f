"""Zero-dependency span tracer: preallocated per-thread ring buffers.

Design constraints (the engine's ordering discipline dictates them):

* **Never block, never allocate on the hot path.**  Each thread owns a
  preallocated ring; an append is a clock read + a list store (~O(100ns)).
  When a ring is full the oldest record is overwritten and a dropped-span
  counter ticks — tracing degrades, it never back-pressures the producer.
* **No RNG, no cross-thread coordination per span.**  The only lock is
  taken once per thread (ring registration) and at snapshot time, so span
  bookkeeping cannot perturb the producer's round-ordered mutations —
  losses stay bit-identical with the tracer on or off (test-enforced).
* **Lanes are thread names.**  The producer's spans land on the
  ``pollen-pack*`` lane, per-shard sync spans on ``pollen-sync*`` lanes,
  consumer spans on ``MainThread`` — which is exactly the Perfetto track
  layout.  :meth:`Tracer.add_span` books a span retroactively on an
  explicit lane (the engine uses it for per-worker sync windows, whose
  durations it already measures for telemetry).

Record format (shared with :mod:`repro.obs.perfetto` and the flight
recorder): ``(ph, name, t0, dur_or_value, lane, depth, attrs)`` where
``ph`` is ``"X"`` (duration span), ``"I"`` (instant), or ``"C"``
(counter sample); ``t0`` is a ``time.perf_counter()`` timestamp.
"""

from __future__ import annotations

import threading
import time

__all__ = ["Tracer", "NullTracer", "NULL_TRACER"]


class _Ring:
    """Fixed-capacity overwrite-oldest record buffer (single writer)."""

    __slots__ = ("buf", "head", "n", "dropped")

    def __init__(self, capacity: int):
        self.buf: list = [None] * capacity
        self.head = 0            # next write slot
        self.n = 0               # live records
        self.dropped = 0         # overwritten-oldest count

    def append(self, rec) -> None:
        buf = self.buf
        if self.n == len(buf):
            self.dropped += 1
        else:
            self.n += 1
        h = self.head
        buf[h] = rec
        self.head = (h + 1) % len(buf)

    def records(self) -> list:
        if self.n < len(self.buf):
            return self.buf[: self.n]
        h = self.head
        return self.buf[h:] + self.buf[:h]


class _SpanCtx:
    """Reentrant-per-thread span context: clock read on enter, one ring
    append on exit.  Depth is tracked per thread so nested spans render
    as a stack in the Perfetto track."""

    __slots__ = ("_tracer", "_name", "_attrs", "_t0")

    def __init__(self, tracer, name, attrs):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        tl = self._tracer._tl()
        tl.depth += 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tl = self._tracer._tl()
        tl.depth -= 1
        tl.ring.append(("X", self._name, self._t0, t1 - self._t0,
                        tl.lane, tl.depth, self._attrs))
        return False


class Tracer:
    """Process-wide span collector over per-thread rings.

    ``capacity`` is per thread lane; a full ring overwrites its oldest
    record (``dropped`` counts them) — the tracer doubles as the flight
    recorder's in-memory retention window.
    """

    enabled = True

    def __init__(self, capacity: int = 4096):
        self.capacity = max(16, int(capacity))
        self._local = threading.local()
        self._lock = threading.Lock()
        self._rings: list[tuple[str, _Ring]] = []

    def _tl(self):
        tl = self._local
        if getattr(tl, "ring", None) is None:
            tl.ring = _Ring(self.capacity)
            tl.lane = threading.current_thread().name
            tl.depth = 0
            with self._lock:
                self._rings.append((tl.lane, tl.ring))
        return tl

    # -- recording ---------------------------------------------------------
    def span(self, name: str, **attrs) -> _SpanCtx:
        """Context manager timing a section on the calling thread's lane."""
        return _SpanCtx(self, name, attrs or None)

    def instant(self, name: str, **attrs) -> None:
        """A point event (controller decisions, compiles, failures)."""
        tl = self._tl()
        tl.ring.append(("I", name, time.perf_counter(), 0.0, tl.lane,
                        tl.depth, attrs or None))

    def counter(self, name: str, value: float) -> None:
        """A counter-track sample (cache hit rate, online pool, bytes)."""
        tl = self._tl()
        tl.ring.append(("C", name, time.perf_counter(), float(value),
                        tl.lane, 0, None))

    def add_span(self, name: str, t0: float, dur: float, *,
                 lane: str | None = None, **attrs) -> None:
        """Book an already-measured span retroactively — used for windows
        the engine times anyway (per-worker device sync), on an explicit
        lane so each worker renders as its own track."""
        tl = self._tl()
        tl.ring.append(("X", name, float(t0), max(float(dur), 0.0),
                        lane if lane is not None else tl.lane, 0,
                        attrs or None))

    # -- reading -----------------------------------------------------------
    def snapshot(self) -> list:
        """Every retained record across all lanes, oldest first."""
        with self._lock:
            rings = list(self._rings)
        recs: list = []
        for _, ring in rings:
            recs.extend(ring.records())
        recs.sort(key=lambda r: r[2])
        return recs

    @property
    def dropped(self) -> int:
        with self._lock:
            return sum(r.dropped for _, r in self._rings)

    def stats(self) -> dict:
        with self._lock:
            rings = list(self._rings)
        return {"lanes": sorted({lane for lane, _ in rings}),
                "spans": sum(r.n for _, r in rings),
                "dropped": sum(r.dropped for _, r in rings),
                "capacity": self.capacity}


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class NullTracer:
    """The disabled tracer: every call is a constant-time no-op, so the
    engine threads tracing unconditionally and pays ~nothing when off."""

    enabled = False
    capacity = 0
    dropped = 0

    def span(self, name, **attrs):
        return _NULL_CTX

    def instant(self, name, **attrs):
        pass

    def counter(self, name, value):
        pass

    def add_span(self, name, t0, dur, *, lane=None, **attrs):
        pass

    def snapshot(self):
        return []

    def stats(self):
        return {"lanes": [], "spans": 0, "dropped": 0, "capacity": 0}


NULL_TRACER = NullTracer()
