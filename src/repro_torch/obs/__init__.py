"""Observability plane of the port: span tracer, metrics registry and the
round critique (copies of ``repro/obs``'s tracer, metrics and critique
modules).  The Perfetto export and the flight recorder are not
ported yet (ROADMAP M8 deferrals).

When no bundle rides the engine it uses :data:`NULL_TRACER`, whose every
site is a constant-time no-op."""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.obs.critique import RoundCritique, critique_round
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER, NullTracer, Tracer

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "MetricsRegistry",
           "RoundCritique", "critique_round", "Observability",
           "make_observability", "SPANS_PER_ROUND"]

# Ring sizing: a round books ~a dozen producer spans and a few counters —
# 64 per retained round is a comfortable bound.
SPANS_PER_ROUND = 64


@dataclass
class Observability:
    """The bundle the engine threads through its round lifecycle."""

    tracer: Tracer
    metrics: MetricsRegistry


def make_observability(*, trace_rounds: int = 64) -> Observability:
    """A wired bundle whose tracer retains ~``trace_rounds`` rounds of
    spans per lane."""
    tracer = Tracer(capacity=max(1, int(trace_rounds)) * SPANS_PER_ROUND)
    return Observability(tracer=tracer, metrics=MetricsRegistry())
