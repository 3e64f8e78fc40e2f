"""Framework policies for the cluster simulator (paper §2.4-2.5, §5.3).

Each policy captures the architectural signature of one simulator:

* ``pollen``   — push-based one-shot placement; Table 3 concurrency; RR for
                 two warm-up rounds then Learning-Based placement (Eq. 3 fit
                 + Eq. 4 correction, LPT assignment); partial aggregation.
* ``pollen_rr`` / ``pollen_bb`` — Pollen's engine with the baseline
                 placements (paper Table 2 / Figs. 14-19 ablations).
* ``parrot``   — push-based but one worker per GPU (no VRAM awareness) and a
                 *linear* time model (§4.2.1 "critical difference").
* ``flower``   — pull-based queue; same concurrency level for all GPU types
                 (the least capable is the reference, §2.5); full aggregation
                 at the server; Ray per-task overhead.
* ``fedscale`` — pull-based; per-client gRPC overhead, dataloader contention
                 (loads whole datasets per worker, §2.5), 1 worker for MLM;
                 fails to aggregate very large cohorts (paper Fig. 11
                 asterisks).
* ``flute``    — pull-based, one worker per GPU, NCCL-ish lockstep.

``run_experiment`` drives any policy for R rounds and returns per-round
stats + the extrapolated total (paper A.1: measure 100 rounds, extrapolate
to 5000).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.placement import (BatchesBasedPlacement, ClientInfo,
                                  LearningBasedPlacement,
                                  RoundRobinPlacement, WorkerInfo)
from repro_torch.simcluster.engine import (RoundStats, Worker, client_time,
                                     make_workers, simulate_pull_round,
                                     simulate_push_round)
from repro_torch.simcluster.profiles import ClusterSpec, TaskProfile

__all__ = ["FRAMEWORKS", "run_experiment", "ExperimentResult"]


@dataclass
class ExperimentResult:
    framework: str
    task: str
    rounds: list                  # RoundStats
    extrapolated_rounds: int

    @property
    def mean_round_time(self) -> float:
        return float(np.mean([r.wall_time for r in self.rounds]))

    @property
    def total_time(self) -> float:
        return self.mean_round_time * self.extrapolated_rounds

    @property
    def mean_idle(self) -> float:
        return float(np.mean([r.idle_time for r in self.rounds]))

    @property
    def total_idle(self) -> float:
        return float(np.sum([r.idle_time for r in self.rounds]))

    @property
    def mean_utilization(self) -> float:
        return float(np.mean([r.gpu_utilization for r in self.rounds]))


def _to_placement_workers(workers: list[Worker]) -> list[WorkerInfo]:
    return [WorkerInfo(wid=w.wid, type_name=w.gpu_type,
                       concurrency=w.concurrency) for w in workers]


class _PushPolicy:
    """Shared machinery for push-based frameworks (Pollen family, Parrot)."""

    name = "push"
    one_worker_per_gpu = False
    partial_agg = True
    dataload = 0.0

    def __init__(self):
        self.placement = None

    def make_placement(self):
        raise NotImplementedError

    def round(self, rng, task: TaskProfile, cluster: ClusterSpec,
              workers, cohort_sizes, round_idx: int) -> RoundStats:
        if self.placement is None:
            self.placement = self.make_placement()
        pw = _to_placement_workers(workers)
        clients = [ClientInfo(cid=i, n_batches=int(x))
                   for i, x in enumerate(cohort_sizes)]
        assignment = self.placement.assign(clients, pw)
        assign_x = {wid: [c.n_batches for c in cs]
                    for wid, cs in assignment.per_worker.items()}
        stats = simulate_push_round(
            rng, task, workers, assign_x, dataload_contention=self.dataload,
            partial_agg=self.partial_agg, n_nodes=len(cluster.nodes))
        # feed telemetry back into the LB model (per-client ground truth)
        if isinstance(self.placement, LearningBasedPlacement):
            by_wid = {w.wid: w for w in workers}
            for wid, cs in assignment.per_worker.items():
                w = by_wid[wid]
                for c in cs:
                    t = client_time(rng, task, w.gpu_type, c.n_batches,
                                    w.concurrency,
                                    dataload_contention=self.dataload)
                    self.placement.observe(round_idx,
                                           pw[0].__class__(  # WorkerInfo
                                               wid=wid,
                                               type_name=w.gpu_type,
                                               concurrency=w.concurrency),
                                           c.n_batches, t)
            self.placement.refit(round_idx + 1)
        return stats


class PollenPolicy(_PushPolicy):
    name = "pollen"

    def make_placement(self):
        return LearningBasedPlacement()


class PollenRRPolicy(_PushPolicy):
    name = "pollen_rr"

    def make_placement(self):
        return RoundRobinPlacement()


class PollenBBPolicy(_PushPolicy):
    name = "pollen_bb"

    def make_placement(self):
        return BatchesBasedPlacement()


class _LinearModel:
    """Parrot's linear time model wrapped as a placement (LPT on a*x+b)."""

    def __init__(self):
        from repro_torch.core.timemodel import fit_linear
        self._fit_linear = fit_linear
        self._data: dict[str, list] = {}
        self._fits: dict[str, object] = {}
        self._fallback = RoundRobinPlacement()
        self.name = "parrot_linear"

    def observe(self, round_idx, worker, x, t):
        self._data.setdefault(worker.type_name, []).append((float(x),
                                                            float(t)))

    def refit(self, round_idx):
        for k, rows in self._data.items():
            xs = np.array([r[0] for r in rows])
            ts = np.array([r[1] for r in rows])
            self._fits[k] = self._fit_linear(xs, ts)

    def assign(self, clients, workers):
        if not all(w.type_name in self._fits for w in workers):
            return self._fallback.assign(clients, workers)
        import heapq
        per = {w.wid: [] for w in workers}
        loads = [(0.0, i, w.wid) for i, w in enumerate(workers)]
        heapq.heapify(loads)
        fit = {w.wid: self._fits[w.type_name] for w in workers}
        for c in sorted(clients, key=lambda c: -c.n_batches):
            load, rank, wid = heapq.heappop(loads)
            per[wid].append(c)
            load += float(fit[wid].predict(c.n_batches))
            heapq.heappush(loads, (load, rank, wid))
        from repro_torch.core.placement import Assignment
        return Assignment(per_worker=per)


class ParrotPolicy(_PushPolicy):
    name = "parrot"
    one_worker_per_gpu = True     # §2.5: cannot account for VRAM

    def make_placement(self):
        return _LinearModel()

    def round(self, rng, task, cluster, workers, cohort_sizes, round_idx):
        stats = super().round(rng, task, cluster, workers, cohort_sizes,
                              round_idx)
        if isinstance(self.placement, _LinearModel):
            by_wid = {w.wid: w for w in workers}
            for wid, w in by_wid.items():
                # parrot profiles on the fly from per-round worker means
                pass
        return stats


class _PullPolicy:
    name = "pull"
    one_worker_per_gpu = False
    uniform_concurrency = False
    partial_agg = False
    dataload = 0.0
    per_client_overhead = 0.0
    fail_cohort_above: int | None = None
    mlm_single_worker = False

    def round(self, rng, task, cluster, workers, cohort_sizes, round_idx):
        if self.fail_cohort_above and len(cohort_sizes) > self.fail_cohort_above:
            raise RuntimeError(
                f"{self.name}: aggregation failed at cohort "
                f"{len(cohort_sizes)} (paper Fig. 11 asterisk)")
        return simulate_pull_round(
            rng, task, workers, list(cohort_sizes),
            dataload_contention=self.dataload,
            per_client_overhead=self.per_client_overhead,
            partial_agg=self.partial_agg)


class FlowerPolicy(_PullPolicy):
    name = "flower"
    uniform_concurrency = True    # least-capable GPU sets the level (§2.5)
    # Ray actor dispatch + object-store (de)serialization of the model per
    # client — the memory-copy inefficiency §2.5/§3.4 calls out.
    per_client_overhead = 1.2


class FedScalePolicy(_PullPolicy):
    name = "fedscale"
    per_client_overhead = 2.0     # gRPC round-trips (+ reconnect retries)
    mlm_single_worker = True      # RAM-bound dataloading (§5)
    fail_cohort_above = 8000      # IC very-large aggregation failure

    @property
    def dataload(self):           # loads whole dataset per worker
        return self._dataload

    def __init__(self):
        self._dataload = 0.0      # set per task in make_framework_workers


class FlutePolicy(_PullPolicy):
    name = "flute"
    one_worker_per_gpu = True     # §2.5: does not saturate VRAM
    per_client_overhead = 0.8     # NCCL-lockstep dispatch


FRAMEWORKS = {
    "pollen": PollenPolicy,
    "pollen_rr": PollenRRPolicy,
    "pollen_bb": PollenBBPolicy,
    "parrot": ParrotPolicy,
    "flower": FlowerPolicy,
    "fedscale": FedScalePolicy,
    "flute": FlutePolicy,
}


def make_framework_workers(policy, task: TaskProfile, cluster: ClusterSpec):
    one = getattr(policy, "one_worker_per_gpu", False)
    uni = getattr(policy, "uniform_concurrency", False)
    workers = make_workers(cluster, task, one_worker_per_gpu=one,
                           uniform_concurrency=uni)
    if getattr(policy, "mlm_single_worker", False) and task.name == "mlm":
        workers = [w for w in workers if w.wid == 0]
    if isinstance(policy, FedScalePolicy):
        policy._dataload = task.dataload_cost
    return workers


def run_experiment(framework: str, task: TaskProfile, cluster: ClusterSpec,
                   cohort_sampler, *, rounds: int = 20,
                   extrapolate_to: int = 5000, seed: int = 1337
                   ) -> ExperimentResult:
    """Simulate ``rounds`` rounds; cohort_sampler(round) -> list of client
    batch counts."""
    rng = np.random.default_rng(seed)
    policy = FRAMEWORKS[framework]()
    workers = make_framework_workers(policy, task, cluster)
    stats = []
    for r in range(rounds):
        cohort = cohort_sampler(r)
        stats.append(policy.round(rng, task, cluster, workers, cohort, r))
    return ExperimentResult(framework=framework, task=task.name,
                            rounds=stats, extrapolated_rounds=extrapolate_to)
