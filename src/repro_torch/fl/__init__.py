from .round import RoundMetrics, StepCompileCache, make_round_step
from .strategy import FedAvg, Strategy

__all__ = ["FedAvg", "RoundMetrics", "StepCompileCache", "Strategy",
           "make_round_step"]
