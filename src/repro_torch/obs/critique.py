"""RoundCritique: where did this round's wall time actually go?

Derived per round from quantities the engine already measures (so the
pass is tracer-independent and costs a handful of float ops):

* **idle-gap fraction** — the paper's utilization claim as a number:
  ``idle_time / (makespan * n_workers)``, the fraction of worker-seconds
  the placement left idle inside the round's makespan.  Both inputs come
  from the deterministic placement simulation, so the value is
  bit-identical across pipeline depths and tracer on/off — which is what
  lets the perf gate put a band on it.
* **per-worker idle gaps** (mesh runs) — from the measured per-worker
  sync windows: worker ``i``'s gap is the part of the round's execution
  wall it did not occupy, ``max(0, 1 - meas_i / exec_s)``.  Wall-clock
  derived, so reported for observability (flight dumps, traces) but
  never gated bitwise.
* **critical-path attribution** — which stage bounded the round:
  ``exec`` (device step), ``pack`` (producer prep not hidden by
  overlap), ``barrier`` (refit-barrier stall), or ``combine``
  (cross-shard reduction).  Computed from the measured stage walls.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["RoundCritique", "critique_round"]


@dataclass
class RoundCritique:
    round_idx: int
    idle_fraction: float          # simulated worker-seconds left idle
    overlap_fraction: float       # prep wall hidden behind execution
    critical_path: str            # exec | pack | barrier | combine
    per_worker_idle: dict = field(default_factory=dict)   # wid -> gap

    def as_dict(self) -> dict:
        return {"round": self.round_idx,
                "idle_fraction": self.idle_fraction,
                "overlap_fraction": self.overlap_fraction,
                "critical_path": self.critical_path,
                "per_worker_idle": {str(k): v for k, v
                                    in self.per_worker_idle.items()}}


def critique_round(*, round_idx: int, pack_s: float, overlap_s: float,
                   exec_s: float, combine_s: float = 0.0,
                   barrier_stall_s: float = 0.0, makespan: float = 0.0,
                   idle_time: float = 0.0, n_workers: int = 0,
                   worker_meas=None) -> RoundCritique:
    """Attribute one round's wall time.  ``worker_meas`` is the engine's
    ``[(wid, meas_s), ...]`` per-worker sync windows (mesh runs only)."""
    idle_fraction = 0.0
    if makespan > 0.0 and n_workers > 0:
        idle_fraction = max(0.0, idle_time / (makespan * n_workers))
    overlap_fraction = overlap_s / pack_s if pack_s > 0 else 0.0
    # Stage walls: the barrier stall happens inside prep, so subtract it
    # from the exposed (un-overlapped) pack time; the combine is inside
    # the execution wall.  Ties resolve to the earlier dict entry.
    exposed_pack = max(pack_s - overlap_s, 0.0)
    stages = {
        "exec": max(exec_s - combine_s, 0.0),
        "pack": max(exposed_pack - barrier_stall_s, 0.0),
        "barrier": max(barrier_stall_s, 0.0),
        "combine": max(combine_s, 0.0),
    }
    critical_path = max(stages, key=stages.get)
    per_worker_idle: dict = {}
    if worker_meas and exec_s > 0.0:
        for wid, meas in worker_meas:
            per_worker_idle[int(wid)] = max(0.0, 1.0 - meas / exec_s)
    return RoundCritique(round_idx=round_idx, idle_fraction=idle_fraction,
                         overlap_fraction=overlap_fraction,
                         critical_path=critical_path,
                         per_worker_idle=per_worker_idle)
