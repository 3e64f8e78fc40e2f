from .round import (RoundMetrics, StepCompileCache, make_gather_round_step,
                    make_round_step)
from .strategy import FedAvg, FedMedian, Strategy, strategy_from_name

__all__ = ["FedAvg", "FedMedian", "RoundMetrics", "StepCompileCache",
           "Strategy", "make_gather_round_step", "make_round_step",
           "strategy_from_name"]
