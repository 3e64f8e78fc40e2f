"""Chrome/Perfetto trace-event export for tracer snapshots.

Emits the JSON trace-event format both ``chrome://tracing`` and
https://ui.perfetto.dev load directly: one process (pid 0, the engine
host), one thread track per tracer lane (producer, consumer, per-worker
sync lanes), ``"X"`` duration events for spans, ``"i"`` instants for
point events (controller decisions, compiles), and ``"C"`` counter
tracks (cache hit rate, online pool, combine bytes).  Timestamps are
microseconds relative to the earliest retained record, so traces start
at t=0 regardless of process uptime.
"""

from __future__ import annotations

import json
import os
import tempfile

__all__ = ["trace_events", "write_trace"]

PROCESS_NAME = "pollen-engine"


def _json_safe(attrs) -> dict:
    if not attrs:
        return {}
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (str, int, float, bool)) or v is None:
            out[str(k)] = v
        else:
            out[str(k)] = repr(v)
    return out


def trace_events(records: list) -> list[dict]:
    """Tracer records -> trace-event dicts (metadata events first).

    ``records`` is :meth:`repro_torch.obs.tracer.Tracer.snapshot` output:
    ``(ph, name, t0, dur_or_value, lane, depth, attrs)`` tuples."""
    lanes: list[str] = []
    for rec in records:
        lane = rec[4]
        if lane not in lanes:
            lanes.append(lane)
    tid_of = {lane: i + 1 for i, lane in enumerate(sorted(lanes))}
    events: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": PROCESS_NAME}},
    ]
    for lane, tid in sorted(tid_of.items(), key=lambda kv: kv[1]):
        events.append({"ph": "M", "name": "thread_name", "pid": 0,
                       "tid": tid, "args": {"name": lane}})
    if not records:
        return events
    base = min(rec[2] for rec in records)
    for ph, name, t0, dv, lane, depth, attrs in records:
        ts = (t0 - base) * 1e6
        if ph == "X":
            events.append({"ph": "X", "cat": "pollen", "name": name,
                           "pid": 0, "tid": tid_of[lane], "ts": ts,
                           "dur": max(dv, 0.0) * 1e6,
                           "args": _json_safe(attrs)})
        elif ph == "I":
            events.append({"ph": "i", "cat": "pollen", "name": name,
                           "pid": 0, "tid": tid_of[lane], "ts": ts,
                           "s": "t", "args": _json_safe(attrs)})
        elif ph == "C":
            events.append({"ph": "C", "name": name, "pid": 0, "tid": 0,
                           "ts": ts, "args": {"value": dv}})
    return events


def write_trace(path: str, records: list) -> str:
    """Atomically write ``{"traceEvents": [...]}`` for ``records``."""
    payload = {"traceEvents": trace_events(records),
               "displayTimeUnit": "ms"}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path
