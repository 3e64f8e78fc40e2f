"""Calibration profiles for the discrete-event cluster simulator.

Everything here is anchored to numbers the paper reports:

* model sizes — Table 6 caption: TG 3.28 MB, IC 26.45 MB, MLM 60.37 MB,
  SR 85.14 MB;
* per-GPU-type concurrency — Table 3 (A40 vs 2080 Ti, per task);
* aggregation cost — Tables 6/7: FedAvg ≈ 1.05 s per (1000 models × 26.45 MB)
  → ~1.05e-9 s/byte/model; FedMedian ≈ 6× that;
* client training-time curves — the Eq. 3 log-linear family with per-task ×
  per-GPU coefficients chosen so medium-scale round times land in the
  paper's Fig. 8 range (minutes/round), and the A40:2080Ti speed ratio
  matches Fig. 4's gap;
* communication — 10 GbE research cluster: 1.25 GB/s, 5 ms/message.

Absolute seconds are calibration, not measurement — the paper itself says
"absolute numbers ... strongly depend on hardware"; what the benchmarks
assert is the *relative* structure (ordering, scaling exponents, idle-time
ratios), which is hardware-independent.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

__all__ = ["GPUSpec", "TaskProfile", "ClusterSpec", "GPUS", "TASKS",
           "single_node", "multi_node", "AGG_RATE_FEDAVG",
           "AGG_RATE_FEDMEDIAN", "NET_BW", "NET_LATENCY",
           "AvailabilityTrace", "REGIONS"]

NET_BW = 1.25e9          # bytes/s (10 GbE)
NET_LATENCY = 5e-3       # s per message
AGG_RATE_FEDAVG = 1.05e-9     # s per byte per model at the server (Table 6)
AGG_RATE_FEDMEDIAN = 6.3e-9   # Table 7


@dataclass(frozen=True)
class GPUSpec:
    name: str
    speed: float             # relative batches/s (A40 = 1.0)
    vram_bytes: int
    # Eq. 3 ground-truth coefficients at concurrency 1 (seconds):
    a: float = 0.05          # s/batch
    b: float = 0.6
    c: float = 1.0
    d: float = 1.0           # per-client fixed cost (model load, setup)
    conc_alpha: float = 0.30 # per-client slowdown ~ conc**alpha (Fig. 3/4:
                             # the GPU gap persists at deployed concurrency)
    noise: float = 0.08
    small_noise: float = 0.30
    small_x: int = 16


A40 = GPUSpec(name="a40", speed=1.0, vram_bytes=48 << 30,
              a=0.045, b=0.8, c=0.5, d=1.2)
# The 2080 Ti is ~2.5-3x slower per batch with a higher fixed cost (paper
# Fig. 4's gap) — this is what Batches-Based placement cannot see.
RTX2080TI = GPUSpec(name="2080ti", speed=0.38, vram_bytes=11 << 30,
                    a=0.13, b=1.1, c=0.5, d=2.2)
GPUS = {g.name: g for g in (A40, RTX2080TI)}


@dataclass(frozen=True)
class TaskProfile:
    name: str
    model_bytes: float            # Table 6
    time_scale: float             # per-task multiplier on GPU curves
    vram_per_client: int          # drives Table 3 concurrency
    dataload_cost: float = 0.0    # CPU-side s/batch (FedScale bottleneck)
    concurrency: dict = field(default_factory=dict)  # Table 3 per GPU type
    util_u1: float = 0.15         # single-worker GPU util (Table 4 anchors)
    util_beta: float = 0.5        # util(c) = min(.98, u1 * c**beta)

    def gpu_util(self, concurrency: int) -> float:
        return min(0.98, self.util_u1 * concurrency ** self.util_beta)


# Table 3 concurrency — {gpu: processes}; Table 4 utilization anchors
# (u1 = the 1-worker frameworks' util; beta from Pollen's measured util).
TASKS = {
    "tg": TaskProfile("tg", 3.28e6, 0.15, int(1.3 * 2**30), 0.002,
                      {"a40": 33, "2080ti": 10},
                      util_u1=0.22, util_beta=0.39),
    "ic": TaskProfile("ic", 26.45e6, 1.0, int(3.2 * 2**30), 0.02,
                      {"a40": 14, "2080ti": 4},
                      util_u1=0.1375, util_beta=0.723),
    "sr": TaskProfile("sr", 85.14e6, 1.3, int(2.1 * 2**30), 0.03,
                      {"a40": 21, "2080ti": 7},
                      util_u1=0.0484, util_beta=0.487),
    "mlm": TaskProfile("mlm", 60.37e6, 2.0, int(3.3 * 2**30), 0.06,
                       {"a40": 14, "2080ti": 3},
                       util_u1=0.2228, util_beta=0.488),
}


# -- client availability (open-world population) ------------------------------
# FedScale / pfl-research both argue that realistic availability traces are
# what make simulator results generalize: devices come online in diurnal
# waves, phase-shifted per region.  The trace is the *rate* half of the
# population model — which individual clients are online is decided by the
# nested-threshold rule in repro_torch.population.arrival (stable, deterministic
# membership: a client stays online while its hash phase is below the rate).

@dataclass(frozen=True)
class AvailabilityTrace:
    """Diurnal online-fraction curve for one region of the population.

    ``online_fraction(t) = clip(base + amplitude * sin(2*pi*(t/period +
    phase)))`` — ``period`` is in rounds (one simulated day), ``phase`` is
    the region's timezone offset as a fraction of a period, and ``weight``
    is the region's share of the registered population.
    """

    name: str
    weight: float            # share of the registered population
    base: float              # mean online fraction
    amplitude: float         # diurnal swing around the mean
    phase: float             # timezone offset, fraction of a period
    period: float = 48.0     # rounds per simulated day

    def __post_init__(self):
        if not 0.0 < self.weight <= 1.0:
            raise ValueError("weight must be in (0, 1]")
        if self.period <= 0:
            raise ValueError("period must be positive")

    def online_fraction(self, t: float) -> float:
        f = self.base + self.amplitude * math.sin(
            2.0 * math.pi * (t / self.period + self.phase))
        return min(1.0, max(0.0, f))


# Three phase-shifted regions (the planet in thirds): equal diurnal shape,
# offset by a third of a day each, weights summing to 1.
REGIONS = {
    "amer": AvailabilityTrace("amer", 0.35, 0.45, 0.25, 0.0),
    "emea": AvailabilityTrace("emea", 0.30, 0.45, 0.25, 1.0 / 3.0),
    "apac": AvailabilityTrace("apac", 0.35, 0.45, 0.25, 2.0 / 3.0),
}


@dataclass(frozen=True)
class NodeSpec:
    name: str
    gpus: tuple                   # GPUSpec names
    cpu_cores: int


@dataclass(frozen=True)
class ClusterSpec:
    nodes: tuple

    def gpu_list(self):
        """[(node_idx, gpu_type_name)]"""
        out = []
        for ni, n in enumerate(self.nodes):
            for g in n.gpus:
                out.append((ni, g))
        return out


def single_node() -> ClusterSpec:
    """§5.2 single-node: one A40 (node 0, 11 CPU cores)."""
    return ClusterSpec(nodes=(NodeSpec("node0", ("a40",), 11),))


def multi_node() -> ClusterSpec:
    """§5.2 multi-node: 1×A40 + 3×2080 Ti across two nodes."""
    return ClusterSpec(nodes=(
        NodeSpec("node0", ("a40",), 11),
        NodeSpec("node1", ("2080ti", "2080ti", "2080ti"), 24),
    ))
