"""Observability plane: span tracer, metrics registry, round critique,
Perfetto export, and the flight recorder.

One :class:`Observability` bundle rides the engine as a single optional
kwarg; ``make_observability`` builds a fully wired one.  When absent the
engine uses :data:`~repro_torch.obs.tracer.NULL_TRACER` — every instrumentation
site stays in place at ~zero cost, and results are bit-identical with
tracing on or off (test-enforced)."""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.obs.critique import RoundCritique, critique_round
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.perfetto import trace_events, write_trace
from repro_torch.obs.tracer import NULL_TRACER, NullTracer, Tracer

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "MetricsRegistry",
           "RoundCritique", "critique_round", "FlightRecorder",
           "trace_events", "write_trace", "Observability",
           "make_observability", "SPANS_PER_ROUND"]

# Ring sizing: a round books ~a dozen producer spans, a sync span per
# worker, a few counters — 64 per retained round is a comfortable bound.
SPANS_PER_ROUND = 64


@dataclass
class Observability:
    """The bundle the engine threads through its round lifecycle."""

    tracer: Tracer
    metrics: MetricsRegistry
    flight: FlightRecorder | None = None


def make_observability(*, trace_rounds: int = 64, flight_rounds: int = 0,
                       flight_path: str = "flight.json") -> Observability:
    """Build a wired bundle: the tracer retains ~``trace_rounds`` rounds
    of spans per lane; ``flight_rounds > 0`` adds a flight recorder that
    keeps that many round summaries and dumps on failure."""
    tracer = Tracer(capacity=max(1, int(trace_rounds)) * SPANS_PER_ROUND)
    metrics = MetricsRegistry()
    flight = None
    if flight_rounds > 0:
        flight = FlightRecorder(tracer, metrics, rounds=flight_rounds,
                                path=flight_path)
    return Observability(tracer=tracer, metrics=metrics, flight=flight)
