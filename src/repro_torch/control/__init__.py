"""Closed-loop control plane: measured telemetry with a depth-aware refit
barrier, drift detection, and adaptive per-worker concurrency."""

from repro_torch.control.autoconc import AdaptiveConcurrency, SlotState
from repro_torch.control.controller import ControllerConfig, ControlPlane, PreRound
from repro_torch.control.drift import DriftDetector, DriftState, relative_errors
from repro_torch.control.scenarios import SCENARIOS, run_scenario
from repro_torch.control.sidecar import SidecarChannel, SidecarRecord, replay_records
from repro_torch.control.telemetry import FlushResult, MeasuredTelemetry, audit_violations

__all__ = [
    "AdaptiveConcurrency",
    "ControlPlane",
    "ControllerConfig",
    "DriftDetector",
    "DriftState",
    "FlushResult",
    "MeasuredTelemetry",
    "PreRound",
    "SCENARIOS",
    "SidecarChannel",
    "SidecarRecord",
    "SlotState",
    "audit_violations",
    "replay_records",
    "relative_errors",
    "run_scenario",
]
