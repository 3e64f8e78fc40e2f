"""Aggregation strategies (paper §3.3) — port of ``repro/fl/strategy.py``.

Associative strategies (FedAvg) ride the partial-aggregation fast path;
non-associative ones (FedMedian) use the gather path, where the round step
returns every lane's trained model and :meth:`Strategy.reduce` aggregates
them in one shot.  Trees are ``{name: Tensor}`` dicts; the engine hands
``reduce`` the round's models as one flat ``[L, n_g]`` leaf per dtype
group (``{key: buffer}``, :class:`~repro_torch.kernels.layout.FlatLayout`)
and the global model's group buffers beside them: each reduce is
coordinate-wise, so it is the same function on these, and every group
reduces in its own dtype, as the reference reduces each leaf in its own.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.aggregation import median_leading, tree_weighted_mean

__all__ = ["Strategy", "FedAvg", "FedMedian", "strategy_from_name"]


@dataclass(frozen=True)
class Strategy:
    name: str = "base"
    associative: bool = True

    def reduce(self, stacked_params, weights, global_params):
        """Server-side one-shot reduce for the gather path."""
        raise NotImplementedError


@dataclass(frozen=True)
class FedAvg(Strategy):
    name: str = "fedavg"
    associative: bool = True
    server_lr: float = 1.0   # 1.0 = plain parameter averaging (McMahan 2017)

    def reduce(self, stacked_params, weights, global_params):
        mean = tree_weighted_mean(stacked_params, weights)
        if self.server_lr == 1.0:
            return mean
        return {k: (g + self.server_lr * (mean[k] - g)).to(g.dtype)
                for k, g in global_params.items()}


@dataclass(frozen=True)
class FedMedian(Strategy):
    """Coordinate-wise median (robust aggregation; Pillutla et al.) — NOT
    associative, so Pollen ships all client models to the server (Table 7
    measures exactly this cost difference vs FedAvg + partial
    aggregation)."""

    name: str = "fedmedian"
    associative: bool = False

    def reduce(self, stacked_params, weights, global_params):
        del weights  # median ignores weights
        return {k: median_leading(x).to(global_params[k].dtype)
                for k, x in stacked_params.items()}


def strategy_from_name(name: str, **kw) -> Strategy:
    name = name.lower()
    if name == "fedavg":
        return FedAvg(**kw)
    if name == "fedmedian":
        return FedMedian(**kw)
    raise ValueError(f"unknown strategy {name!r}")
