from .batching import (PackBuffers, RoundArrays, RoundPlan,
                       build_round_arrays, padding_stats, plan_round)
from .device_cache import CachePlan, DeviceBatchCache
from .federated import TASK_DISTRIBUTIONS, FederatedDataset, make_federated_dataset

__all__ = ["CachePlan", "DeviceBatchCache", "FederatedDataset", "PackBuffers",
           "RoundArrays", "RoundPlan", "TASK_DISTRIBUTIONS",
           "build_round_arrays", "make_federated_dataset", "padding_stats",
           "plan_round"]
