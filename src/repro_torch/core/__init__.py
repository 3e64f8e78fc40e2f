"""Pollen core: resource-aware client placement for FL simulation (port)."""

from .aggregation import (PartialAggregate, fedavg_flat, fold_clients,
                          partial_init, partial_merge, partial_update,
                          tree_weighted_mean)
from .engine import EngineConfig, FederatedEngine, RoundResult, s_bucket
from .placement import (Assignment, BatchesBasedPlacement, ClientInfo,
                        LearningBasedPlacement, Placement,
                        RoundRobinPlacement, WorkerInfo, make_placement)
from .sampling import (DeadlineFilter, PowerOfChoiceSampler, UniformSampler,
                       ZipfSampler, restore_sampler, sampler_state)
from .telemetry import GPUProfile, SyntheticTelemetry, TelemetryStore
from .timemodel import (LogLinearFit, TrainingTimeModel, fit_linear,
                        fit_log_linear)

__all__ = [
    "Assignment", "BatchesBasedPlacement", "ClientInfo", "DeadlineFilter",
    "EngineConfig", "FederatedEngine", "GPUProfile", "LearningBasedPlacement",
    "LogLinearFit", "PartialAggregate", "Placement", "PowerOfChoiceSampler",
    "RoundResult", "RoundRobinPlacement", "SyntheticTelemetry",
    "TelemetryStore", "TrainingTimeModel", "UniformSampler", "WorkerInfo",
    "ZipfSampler", "fedavg_flat", "fit_linear", "fit_log_linear",
    "fold_clients", "make_placement", "partial_init", "partial_merge",
    "partial_update", "restore_sampler", "s_bucket", "sampler_state",
    "tree_weighted_mean",
]
