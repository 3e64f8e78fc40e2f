"""Aggregation strategies (paper §3.3) — port of ``repro/fl/strategy.py``.

Associative strategies ride the partial-aggregation fast path, which is
the only path ported: ``FedAvg``.  The gather path for non-associative
strategies (FedMedian) is not ported yet (ROADMAP M4/M5).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["Strategy", "FedAvg", "strategy_from_name"]


@dataclass(frozen=True)
class Strategy:
    name: str = "base"
    associative: bool = True


@dataclass(frozen=True)
class FedAvg(Strategy):
    name: str = "fedavg"
    associative: bool = True


def strategy_from_name(name: str) -> Strategy:
    name = name.lower()
    if name == "fedavg":
        return FedAvg()
    if name == "fedmedian":
        raise NotImplementedError("FedMedian and the gather path are not "
                                  "ported yet (ROADMAP M4/M5)")
    raise ValueError(f"unknown strategy {name!r}")
