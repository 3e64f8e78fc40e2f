"""Client placement strategies (paper §4.1–4.2).

A *placement* maps a sampled cohort of clients onto workers, one-shot, before
the round starts (push-based, Fig. 5b).  Three strategies:

* ``RoundRobinPlacement``  — Naïve RR: split the cohort into |W| equal lists.
* ``BatchesBasedPlacement``— balance the *number of batches* per worker
  (greedy LPT on batch counts).
* ``LearningBasedPlacement`` — Pollen: predict per-client training time with
  the per-worker-type log-linear model (Eq. 3 + Eq. 4), then LPT: sort clients
  by predicted time descending, repeatedly assign to the worker with the
  smallest accumulated predicted load (workers initially ordered
  fastest-first, §4.2).

Placement is independent of client *selection* (§3.1): the cohort arrives
already sampled.

Workers are described by :class:`WorkerInfo`; heterogeneity enters through
``worker.type_name`` (per-type time models) and ``worker.speed`` (used by the
baselines' tie-breaks and by the synthetic telemetry generator).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from .timemodel import TrainingTimeModel

__all__ = [
    "ClientInfo",
    "WorkerInfo",
    "Assignment",
    "Placement",
    "RoundRobinPlacement",
    "BatchesBasedPlacement",
    "LearningBasedPlacement",
    "make_placement",
    "apply_cache_affinity",
]


@dataclass(frozen=True)
class ClientInfo:
    """What the server knows about a sampled client before training it."""

    cid: int
    n_batches: int          # x in the paper — the placement feature
    n_samples: int = 0      # aggregation weight n_k (defaults to batches)

    @property
    def weight(self) -> int:
        return self.n_samples if self.n_samples > 0 else self.n_batches


@dataclass(frozen=True)
class WorkerInfo:
    """A training worker (a process on a GPU in the paper; a client-slot
    stream of a DP group / pod on TPU)."""

    wid: int
    type_name: str = "default"   # GPU/pod type — selects the time model
    speed: float = 1.0           # relative batches/sec (baseline tie-break)
    concurrency: int = 1         # slots this worker's device supports


@dataclass
class Assignment:
    """Result of a placement: per-worker client lists + diagnostics."""

    per_worker: dict[int, list[ClientInfo]]
    predicted_load: dict[int, float] = field(default_factory=dict)

    def client_ids(self, wid: int) -> list[int]:
        return [c.cid for c in self.per_worker.get(wid, [])]

    def loads(self, time_of=None) -> dict[int, float]:
        """Actual per-worker load under a ground-truth ``time_of(worker, client)``."""
        if time_of is None:
            return {w: float(sum(c.n_batches for c in cs))
                    for w, cs in self.per_worker.items()}
        return {w: float(sum(time_of(w, c) for c in cs))
                for w, cs in self.per_worker.items()}

    def idle_time(self, time_of) -> float:
        """Sum over workers of (makespan - worker finish time): the paper's
        GPU idle-time metric (Table 2)."""
        loads = self.loads(time_of)
        makespan = max(loads.values()) if loads else 0.0
        return float(sum(makespan - v for v in loads.values()))

    def makespan(self, time_of) -> float:
        loads = self.loads(time_of)
        return max(loads.values()) if loads else 0.0


class Placement:
    """Base class; subclasses implement :meth:`assign`."""

    name = "base"

    def assign(self, clients: list[ClientInfo],
               workers: list[WorkerInfo]) -> Assignment:
        raise NotImplementedError


class RoundRobinPlacement(Placement):
    """Paper §4.1: split the client list into |W| uniformly-populated lists,
    remainders to the first workers."""

    name = "rr"

    def assign(self, clients, workers) -> Assignment:
        if not workers:
            raise ValueError("no workers available")
        per = {w.wid: [] for w in workers}
        order = sorted(workers, key=lambda w: w.wid)
        for i, c in enumerate(clients):
            per[order[i % len(order)].wid].append(c)
        return Assignment(per_worker=per)


def _lpt(clients, workers, load_fn, initial_order_key):
    """Greedy LPT: clients sorted by load descending; each goes to the worker
    with the least accumulated load.  ``initial_order_key`` breaks the initial
    all-zero tie (paper: fastest worker first)."""
    per = {w.wid: [] for w in workers}
    # heap of (accumulated_load, initial_rank, wid)
    ranked = sorted(workers, key=initial_order_key)
    heap = [(0.0, rank, w.wid) for rank, w in enumerate(ranked)]
    heapq.heapify(heap)
    loads = {w.wid: 0.0 for w in workers}
    order = sorted(clients, key=lambda c: -load_fn(c.cid))
    for c in order:
        load, rank, wid = heapq.heappop(heap)
        per[wid].append(c)
        load += load_fn(c.cid, wid)
        loads[wid] = load
        heapq.heappush(heap, (load, rank, wid))
    return per, loads


class BatchesBasedPlacement(Placement):
    """Paper §4.1 BB baseline: balance the per-worker *batch counts*.
    Understands neither time-vs-batches scaling nor GPU speed differences."""

    name = "bb"

    def assign(self, clients, workers) -> Assignment:
        if not workers:
            raise ValueError("no workers available")
        by_cid = {c.cid: c for c in clients}

        def load_fn(cid, wid=None):
            return float(by_cid[cid].n_batches)

        per, loads = _lpt(clients, workers, load_fn, lambda w: w.wid)
        return Assignment(per_worker=per, predicted_load=loads)


class LearningBasedPlacement(Placement):
    """Pollen's LB placement (§4.2).

    Holds one :class:`TrainingTimeModel` per worker *type*.  Until every type
    has a ready model (the first two rounds), falls back to RR so telemetry
    stays unbiased (§4.2).  Predicted per-client time on a worker uses that
    worker type's g(x) (Eq. 4).
    """

    name = "lb"

    def __init__(self, worker_types: list[str] | None = None, *,
                 window: int = 1, max_points: int | None = None):
        self.models: dict[str, TrainingTimeModel] = {}
        self.window = window
        self.max_points = max_points
        for t in worker_types or []:
            self._model(t)
        self._fallback = RoundRobinPlacement()
        self.used_fallback = False

    def _model(self, type_name: str) -> TrainingTimeModel:
        if type_name not in self.models:
            self.models[type_name] = TrainingTimeModel(
                window=self.window, max_points=self.max_points)
        return self.models[type_name]

    # -- telemetry plumbing (engine calls these) ---------------------------
    def observe(self, round_idx: int, worker: WorkerInfo, x, t) -> None:
        self._model(worker.type_name).observe(round_idx, x, t)

    def observe_type(self, round_idx: int, type_name: str, x, t) -> None:
        """Record a telemetry row by worker *type* (the control plane's
        measured rows carry the type, not a live WorkerInfo)."""
        self._model(type_name).observe(round_idx, x, t)

    def refit(self, current_round: int) -> None:
        for m in self.models.values():
            m.refit(current_round)

    def ready_for(self, workers) -> bool:
        return all(self._model(w.type_name).ready for w in workers)

    # -- placement ---------------------------------------------------------
    def assign(self, clients, workers) -> Assignment:
        if not workers:
            raise ValueError("no workers available")
        if not self.ready_for(workers):
            self.used_fallback = True
            return self._fallback.assign(clients, workers)
        self.used_fallback = False
        by_cid = {c.cid: c for c in clients}
        # Cache per-type predictions for all distinct x (vectorized).
        xs = np.array(sorted({c.n_batches for c in clients}), dtype=np.float64)
        pred: dict[str, dict[int, float]] = {}
        for t, m in self.models.items():
            if m.ready and len(xs):
                p = np.atleast_1d(m.predict(xs))
                pred[t] = {int(x): float(v) for x, v in zip(xs, p)}
        types = {w.wid: w.type_name for w in workers}
        # Mean predicted time (over types) used for the descending sort.
        mean_pred = {int(x): float(np.mean([pred[t][int(x)] for t in pred]))
                     for x in xs}

        def load_fn(cid, wid=None):
            x = by_cid[cid].n_batches
            if wid is None:
                return mean_pred[int(x)]
            return pred[types[wid]][int(x)]

        # Paper: workers initially sorted fastest first = smallest predicted
        # time for a reference load.
        ref_x = int(xs[-1]) if len(xs) else 1

        def speed_key(w):
            return pred[w.type_name].get(ref_x, 0.0)

        per, loads = _lpt(clients, workers, load_fn, speed_key)
        return Assignment(per_worker=per, predicted_load=loads)


def apply_cache_affinity(assignment: Assignment, workers, shard_of_wid,
                         cached_shard_of, *,
                         live_shards=None) -> tuple[Assignment, int]:
    """Cache-aware post-pass: swap clients so device-cached ones land on the
    mesh shard that already holds their rows.

    Strictly **load-neutral**: a swap exchanges two clients with EQUAL batch
    counts between workers of EQUAL type, so every quantity a placement
    strategy optimizes — per-worker batch totals (BB), per-worker predicted
    times (LB: g(x) depends only on x and the worker's type), makespan,
    idle time — is numerically unchanged; only the cache hit pattern
    improves.  Deterministic: workers and clients are walked in order, the
    first eligible partner wins.

    ``shard_of_wid``: wid -> mesh shard; ``cached_shard_of``: cid -> shard
    currently holding the client's rows (None = not cached, e.g.
    :meth:`repro.data.device_cache.DeviceBatchCache.shard_for_client`).
    ``live_shards``: optional set of shards that still have workers — a
    client whose rows live on a shard outside it (its last worker failed
    mid-churn) is treated as uncached, so stranded entries never steer a
    swap toward a shard nothing can execute on.
    Returns ``(assignment, n_swaps)`` — a new Assignment when swaps
    happened (``predicted_load`` is carried over; it is invariant).
    """
    by_wid = {w.wid: w for w in workers}
    per = {wid: list(cs) for wid, cs in assignment.per_worker.items()}
    # (type, shard, x) -> [(wid, position)] of NON-home clients: candidates
    # that may be displaced without losing a hit (their rows live elsewhere
    # or nowhere).
    candidates: dict[tuple, list] = {}
    misplaced = []  # (wid, position, home_shard)
    for wid in sorted(per):
        w = by_wid[wid]
        shard = shard_of_wid.get(wid)
        if shard is None:
            continue
        for pos, c in enumerate(per[wid]):
            home = cached_shard_of(c.cid)
            if (home is not None and live_shards is not None
                    and home not in live_shards):
                home = None
            if home is None or home != shard:
                candidates.setdefault(
                    (w.type_name, shard, c.n_batches), []).append((wid, pos))
            if home is not None and home != shard:
                misplaced.append((wid, pos, home))
    swapped: set = set()
    n_swaps = 0
    for wid, pos, home in misplaced:
        if (wid, pos) in swapped:
            continue
        w = by_wid[wid]
        key = (w.type_name, home, per[wid][pos].n_batches)
        partner = None
        for cand in candidates.get(key, []):
            if cand not in swapped and cand != (wid, pos):
                partner = cand
                break
        if partner is None:
            continue
        pw, pp = partner
        per[wid][pos], per[pw][pp] = per[pw][pp], per[wid][pos]
        swapped.add((wid, pos))
        swapped.add(partner)
        n_swaps += 1
    if not n_swaps:
        return assignment, 0
    return Assignment(per_worker=per,
                      predicted_load=dict(assignment.predicted_load)), n_swaps


def make_placement(name: str, **kw) -> Placement:
    name = name.lower()
    if name in ("rr", "round_robin", "round-robin"):
        return RoundRobinPlacement()
    if name in ("bb", "batches", "batches_based"):
        return BatchesBasedPlacement()
    if name in ("lb", "learning", "pollen"):
        return LearningBasedPlacement(**kw)
    raise ValueError(f"unknown placement strategy: {name!r}")
