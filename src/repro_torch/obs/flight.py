"""Flight recorder: keep the last N rounds in memory, dump on failure.

The tracer's per-thread rings already retain the most recent spans; the
flight recorder adds a bounded deque of per-round summaries (loss,
critique, key counters) and a crash-safe ``dump()`` that writes
``flight.json`` — spans + round summaries + a metrics snapshot — when
the engine aborts, a prep fails, or the process receives SIGTERM.

``dump()`` is guarded never to raise: it runs inside exception handlers
and signal handlers, where a secondary failure would mask the primary
one.  Repeated dumps overwrite (the newest failure wins); ``dumps``
counts them.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque

__all__ = ["FlightRecorder"]


def _record_json(rec) -> dict:
    ph, name, t0, dv, lane, depth, attrs = rec
    out = {"ph": ph, "name": name, "t0": t0, "lane": lane, "depth": depth}
    if ph == "C":
        out["value"] = dv
    else:
        out["dur"] = dv
    if attrs:
        out["args"] = {str(k): (v if isinstance(
            v, (str, int, float, bool)) or v is None else repr(v))
            for k, v in attrs.items()}
    return out


class FlightRecorder:
    """Bounded in-memory retention + failure dump for one engine run."""

    def __init__(self, tracer, metrics=None, *, rounds: int = 8,
                 path: str = "flight.json"):
        self.tracer = tracer
        self.metrics = metrics
        self.path = path
        self.rounds = max(1, int(rounds))
        self._rounds: deque = deque(maxlen=self.rounds)
        self._lock = threading.Lock()
        self.dumps = 0
        self.last_reason: str | None = None

    def on_round(self, round_idx: int, summary: dict) -> None:
        """Retain one round's summary (consumer-side, at finish time)."""
        with self._lock:
            self._rounds.append({"round": int(round_idx), **summary})

    def dump(self, reason: str) -> str | None:
        """Write flight.json for the current retention window; returns
        the path, or None if the dump itself failed (never raises)."""
        try:
            with self._lock:
                rounds = list(self._rounds)
            payload = {
                "reason": str(reason),
                "unix_time": time.time(),
                "rounds": rounds,
                "spans": [_record_json(r) for r in self.tracer.snapshot()],
                "tracer": self.tracer.stats(),
                "metrics": (self.metrics.snapshot()
                            if self.metrics is not None else None),
            }
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(payload, f)
                os.replace(tmp, self.path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
            self.dumps += 1
            self.last_reason = str(reason)
            return self.path
        except Exception:
            return None
