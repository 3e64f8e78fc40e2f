"""Telemetry: per-client training-time records feeding the placement model.

Two sources:

* :class:`repro.control.telemetry.MeasuredTelemetry` — wall-clock
  measurements from real execution (per-worker round times attributed back
  to clients proportionally to their predicted share; exact per-client times
  on real clusters), delivered through the control plane's depth-aware
  refit barrier (``EngineConfig.telemetry_mode = "measured"``).
* ``SyntheticTelemetry`` — the ground-truth latency generator used by tests,
  benchmarks, and the cluster simulator.  It reproduces the paper's empirical
  structure (Figs. 3/4/7): per-worker-type log-linear mean time with
  heteroscedastic noise (small clients noisier), intra-GPU variability from
  OS scheduling, and concurrency-dependent slowdown (Fig. 3: more concurrent
  workers per GPU ⇒ each client slower, total throughput higher).

Checkpointable: ``state_dict``/``load_state_dict`` round-trips all records so
a resumed experiment keeps its fitted placement model warm.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["TelemetryStore", "SyntheticTelemetry", "GPUProfile"]


@dataclass
class TelemetryStore:
    """Append-only (round, worker_type, x, time) log."""

    records: list = field(default_factory=list)

    def add(self, round_idx: int, worker_type: str, x: float, t: float) -> None:
        self.records.append((int(round_idx), str(worker_type), float(x), float(t)))

    def extend(self, rows) -> None:
        for r in rows:
            self.add(*r)

    def by_type(self, worker_type: str):
        xs = [(r, x, t) for (r, wt, x, t) in self.records if wt == worker_type]
        return xs

    def state_dict(self) -> dict:
        return {"records": list(self.records)}

    def load_state_dict(self, state: dict) -> None:
        self.records = [tuple(r) for r in state["records"]]

    def __len__(self) -> int:
        return len(self.records)


@dataclass(frozen=True)
class GPUProfile:
    """A worker-type latency profile for the synthetic generator / simulator.

    ``a, b, c, d`` are ground-truth Eq. 3 coefficients at concurrency 1;
    ``conc_alpha`` scales per-client time with the number of concurrent
    workers sharing the device (Fig. 3: sub-linear, so concurrency still wins
    in throughput); ``noise`` is the lognormal sigma of multiplicative jitter;
    ``small_noise`` adds extra variance below ``small_x`` batches (Fig. 7's
    cloud of small clients).
    """

    name: str = "a40"
    a: float = 0.05            # sec / batch
    b: float = 0.5
    c: float = 1.0
    d: float = 1.0             # fixed per-client overhead (model copy, setup)
    conc_alpha: float = 0.6    # time multiplier ~ conc**alpha
    noise: float = 0.08
    small_noise: float = 0.35
    small_x: int = 16
    vram_bytes: int = 48 * 2 ** 30   # A40 default
    speed: float = 1.0

    def mean_time(self, x, concurrency: int = 1):
        x = np.asarray(x, dtype=np.float64)
        base = self.a * x + self.b * np.log(self.c * x) + self.d
        return np.maximum(base, 1e-3) * (concurrency ** self.conc_alpha)


# Two representative research-cluster GPUs (paper §5.2) plus a TPU-group
# profile for the adapted system.
A40 = GPUProfile(name="a40", a=0.045, b=0.8, c=0.5, d=1.2, vram_bytes=48 * 2 ** 30,
                 speed=1.0)
RTX2080TI = GPUProfile(name="2080ti", a=0.11, b=1.1, c=0.5, d=1.6,
                       vram_bytes=11 * 2 ** 30, speed=0.42)
TPU_GROUP = GPUProfile(name="tpu-v5e-group", a=0.012, b=0.25, c=1.0, d=0.35,
                       conc_alpha=0.15, noise=0.03, small_noise=0.10,
                       vram_bytes=16 * 2 ** 30, speed=4.0)

PROFILES = {p.name: p for p in (A40, RTX2080TI, TPU_GROUP)}


class SyntheticTelemetry:
    """Ground-truth sampler of client training times (deterministic by seed).

    Checkpointable: ``state_dict``/``load_state_dict`` round-trip the RNG
    stream position (JSON-safe), so a resumed synthetic run re-draws
    exactly the times the uninterrupted run would have.  The engine
    snapshots the state at prepare time per round — like the sampler RNG —
    so deep-pipelined read-ahead cannot corrupt the restore point.
    """

    def __init__(self, profiles: dict[str, GPUProfile] | None = None, *,
                 seed: int = 1337):
        self.profiles = profiles or PROFILES
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def state_dict(self) -> dict:
        return {"seed": int(self.seed),
                "rng": self.rng.bit_generator.state}

    def load_state_dict(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]

    def sample_time(self, worker_type: str, x: int, *, concurrency: int = 1) -> float:
        p = self.profiles[worker_type]
        mean = float(p.mean_time(x, concurrency))
        sigma = p.noise + (p.small_noise if x < p.small_x else 0.0)
        return mean * float(self.rng.lognormal(mean=0.0, sigma=sigma))

    def sample_times(self, worker_type: str, xs, *, concurrency: int = 1) -> np.ndarray:
        return np.array([self.sample_time(worker_type, int(x), concurrency=concurrency)
                         for x in np.atleast_1d(xs)])
