"""Elastic worker management + straggler mitigation.

One-shot per-round placement makes elasticity nearly free (DESIGN.md §6):
the placement is recomputed from the *current* worker pool each round, so a
failed node simply disappears from the next round and a joined node starts
receiving clients immediately.  This module provides:

* :class:`WorkerPool` — the live set of workers with fail/join events, a
  per-round snapshot API, and bootstrap of new workers' time models from
  same-type pooled telemetry (models are per *type*, so a joining worker of
  a known type inherits its peers' telemetry with no RR warm-up relapse —
  test-enforced in ``tests/test_elastic.py``).  ``advance_to`` returns the
  events it fired so the control plane (``repro.control``) can reset drift
  statistics and reseed slot counts for the affected types;
* deadline-based over-sampling (:func:`oversample_cohort`,
  :func:`deadline_trim`) — production-style straggler mitigation (Bonawitz
  et al. 2019): sample (1+rho)·m clients and close the round once the target
  fraction would finish within the deadline.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core.placement import ClientInfo, WorkerInfo

__all__ = ["WorkerPool", "FailureEvent", "oversample_cohort", "deadline_trim"]


@dataclass(frozen=True)
class FailureEvent:
    round_idx: int
    kind: str          # 'fail' | 'join'
    wid: int
    type_name: str = "default"
    speed: float = 1.0
    concurrency: int = 1


@dataclass
class WorkerPool:
    """Live worker set with scheduled or injected failure/join events."""

    workers: dict[int, WorkerInfo] = field(default_factory=dict)
    events: list[FailureEvent] = field(default_factory=list)
    log: list = field(default_factory=list)

    @classmethod
    def homogeneous(cls, n: int, *, type_name: str = "default",
                    speed: float = 1.0, concurrency: int = 1) -> "WorkerPool":
        return cls(workers={i: WorkerInfo(wid=i, type_name=type_name,
                                          speed=speed, concurrency=concurrency)
                            for i in range(n)})

    @classmethod
    def from_specs(cls, specs: list[tuple[str, float, int]]) -> "WorkerPool":
        """specs: list of (type_name, speed, concurrency) — one per worker."""
        return cls(workers={i: WorkerInfo(wid=i, type_name=t, speed=s,
                                          concurrency=c)
                            for i, (t, s, c) in enumerate(specs)})

    # -- events --------------------------------------------------------------
    def schedule(self, event: FailureEvent) -> None:
        self.events.append(event)

    def fail(self, wid: int, *, round_idx: int = -1) -> None:
        if wid in self.workers:
            del self.workers[wid]
            self.log.append(("fail", round_idx, wid))

    def join(self, worker: WorkerInfo, *, round_idx: int = -1) -> None:
        self.workers[worker.wid] = worker
        self.log.append(("join", round_idx, worker.wid))

    def advance_to(self, round_idx: int) -> list[FailureEvent]:
        """Apply all events scheduled at or before ``round_idx``.

        Returned fail events carry the failed worker's ACTUAL type (the
        scheduler rarely knows it), so per-type consumers — the control
        plane's drift reset and slot bookkeeping — see the right type."""
        fired, remaining = [], []
        for e in self.events:
            if e.round_idx <= round_idx:
                if e.kind == "fail":
                    live = self.workers.get(e.wid)
                    if live is not None and e.type_name != live.type_name:
                        e = replace(e, type_name=live.type_name)
                    self.fail(e.wid, round_idx=round_idx)
                else:
                    self.join(WorkerInfo(wid=e.wid, type_name=e.type_name,
                                         speed=e.speed,
                                         concurrency=e.concurrency),
                              round_idx=round_idx)
                fired.append(e)
            else:
                remaining.append(e)
        self.events = remaining
        return fired

    def snapshot(self) -> list[WorkerInfo]:
        if not self.workers:
            raise RuntimeError("worker pool is empty — cannot run a round")
        return sorted(self.workers.values(), key=lambda w: w.wid)

    def type_names(self) -> list[str]:
        """Distinct worker types currently alive (sorted)."""
        return sorted({w.type_name for w in self.workers.values()})

    def __len__(self) -> int:
        return len(self.workers)


def oversample_cohort(sampler, round_idx: int, *, rho: float = 0.2) -> np.ndarray:
    """Sample (1+rho)x the cohort for deadline-based straggler dropping."""
    base = sampler.cohort_size
    extra = int(np.ceil(base * rho))
    orig = sampler.cohort_size
    try:
        sampler.cohort_size = base + extra
        return sampler.sample(round_idx)
    finally:
        sampler.cohort_size = orig


def deadline_trim(clients: list[ClientInfo], target: int, predict=None
                  ) -> list[ClientInfo]:
    """Keep the ``target`` fastest-predicted clients (drop stragglers).

    With no predictor (warm-up rounds) keeps the smallest by batch count.
    """
    if len(clients) <= target:
        return list(clients)
    if predict is None:
        key = {c.cid: float(c.n_batches) for c in clients}
    else:
        xs = np.array([c.n_batches for c in clients], dtype=np.float64)
        pred = np.atleast_1d(predict(xs))
        key = {c.cid: float(p) for c, p in zip(clients, pred)}
    return sorted(clients, key=lambda c: key[c.cid])[:target]
