"""Pollen core: resource-aware client placement for FL simulation (port)."""

from .aggregation import (PartialAggregate, fedavg_flat, fold_clients,
                          partial_init, partial_merge, partial_update,
                          tree_weighted_mean)
from .concurrency import (ConcurrencyEstimate, DeviceSpec,
                          RoundMemoryAnalysis, estimate_slots_analytic,
                          estimate_slots_from_memory_analysis,
                          gpu_concurrency_probe, round_memory_analysis)
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
    "Assignment", "BatchesBasedPlacement", "ClientInfo",
    "ConcurrencyEstimate", "DeadlineFilter", "DeviceSpec", "EngineConfig", "FederatedEngine", "GPUProfile", "LearningBasedPlacement",
    "LogLinearFit", "PartialAggregate", "Placement", "PowerOfChoiceSampler",
    "RoundMemoryAnalysis", "RoundResult", "RoundRobinPlacement", "SyntheticTelemetry",
    "TelemetryStore", "TrainingTimeModel", "UniformSampler", "WorkerInfo",
    "ZipfSampler", "estimate_slots_analytic",
    "estimate_slots_from_memory_analysis", "fedavg_flat", "fit_linear",
    "fit_log_linear", "fold_clients", "gpu_concurrency_probe",
    "make_placement", "partial_init", "partial_merge",
    "partial_update", "restore_sampler", "round_memory_analysis", "s_bucket", "sampler_state",
    "tree_weighted_mean",
]
