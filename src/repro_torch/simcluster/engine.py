"""Discrete-event cluster simulator core.

Simulates one FL experiment round-by-round for a given *framework policy*
(``repro_torch.simcluster.frameworks``) on a given cluster (``profiles``).  The
unit of time is seconds; client training times are drawn from the same
Eq. 3 log-linear + noise family the paper measures (Figs. 3/4/7), per GPU
type, per task, with concurrency-dependent slowdown.

Two execution modes cover the paper's two communication designs:

* ``simulate_pull_round``  — the Fig. 5a queue: every worker round-trips to
  the server per client (download model, train, upload update), modelled
  with per-message latency + model-size/bandwidth transfer times on the
  node's shared link;
* ``simulate_push_round`` — the Fig. 5b one-shot placement: one model copy
  per node + a client-ID list, then workers run their assigned streams
  independently; optional partial aggregation collapses the upload to one
  model per node.

Outputs per round: wall time, per-GPU busy/idle time, bytes moved,
aggregation time — everything Figs. 1/8/9/11-13 and Tables 2/4/5/6/7 need.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from repro_torch.simcluster.profiles import (AGG_RATE_FEDAVG, GPUS, NET_BW,
                                       NET_LATENCY, ClusterSpec, TaskProfile)

__all__ = ["Worker", "RoundStats", "make_workers", "client_time",
           "simulate_pull_round", "simulate_push_round", "agg_time"]


@dataclass(frozen=True)
class Worker:
    wid: int
    node: int
    gpu_idx: int          # global GPU index
    gpu_type: str
    concurrency: int      # total workers sharing this GPU


@dataclass
class RoundStats:
    wall_time: float
    busy_per_gpu: dict            # gpu_idx -> busy worker-seconds
    idle_time: float              # sum over workers of (makespan - busy)
    comm_time: float              # serialized communication seconds
    agg_time: float
    bytes_moved: float
    n_clients: int
    per_worker_finish: dict = field(default_factory=dict)
    gpu_utilization: float = 0.0  # Table 4 model (set by the simulators)
    vram_fraction: float = 0.0    # Table 5 model


def _utilization(task: TaskProfile, workers: list[Worker],
                 busy_per_gpu: dict, finish: dict, wall: float) -> float:
    """Table 4 reproduction: a GPU's time-averaged utilization follows the
    concurrency-saturation curve evaluated at the *average number of active
    workers* over the round (sum of worker busy-seconds / wall)."""
    if wall <= 0:
        return 0.0
    by_gpu: dict[int, list[Worker]] = {}
    for w in workers:
        by_gpu.setdefault(w.gpu_idx, []).append(w)
    utils = []
    for gi, ws in by_gpu.items():
        act = busy_per_gpu.get(gi, 0.0) / wall          # 0..concurrency
        # linear below one active worker, saturation curve above
        u = task.util_u1 * (act if act <= 1.0 else act ** task.util_beta)
        utils.append(min(0.98, u))
    return float(np.mean(utils)) if utils else 0.0


def _vram_fraction(task: TaskProfile, workers: list[Worker]) -> float:
    """Table 5: resident client processes × per-client VRAM / GPU VRAM."""
    from repro_torch.simcluster.profiles import GPUS
    by_gpu: dict[int, list[Worker]] = {}
    for w in workers:
        by_gpu.setdefault(w.gpu_idx, []).append(w)
    fr = []
    for ws in by_gpu.values():
        g = GPUS[ws[0].gpu_type]
        fr.append(min(0.98, len(ws) * task.vram_per_client / g.vram_bytes))
    return float(np.mean(fr)) if fr else 0.0


def make_workers(cluster: ClusterSpec, task: TaskProfile,
                 *, procs_per_gpu: dict | None = None,
                 one_worker_per_gpu: bool = False,
                 uniform_concurrency: bool = False) -> list[Worker]:
    """Expand the cluster into workers.

    * ``one_worker_per_gpu`` — Flute/Parrot (§2.5);
    * ``uniform_concurrency`` — Flower's simulator: one concurrency level for
      every GPU type, so the least capable GPU is the reference (§2.5);
    * otherwise the Table 3 per-type level (Pollen / FedScale).
    """
    conc = dict(procs_per_gpu or task.concurrency)
    gpus = cluster.gpu_list()
    if one_worker_per_gpu:
        conc = {g: 1 for _, g in gpus}
    elif uniform_concurrency:
        level = min(conc.get(g, 1) for _, g in gpus)
        conc = {g: level for _, g in gpus}
    workers = []
    wid = 0
    for gi, (ni, gtype) in enumerate(gpus):
        c = max(1, conc.get(gtype, 1))
        for _ in range(c):
            workers.append(Worker(wid=wid, node=ni, gpu_idx=gi,
                                  gpu_type=gtype, concurrency=c))
            wid += 1
    return workers


def client_time(rng: np.random.Generator, task: TaskProfile, gpu_type: str,
                x: int, concurrency: int, *, dataload_contention: float = 0.0
                ) -> float:
    """One client's wall training time on one worker (Eq. 3 family + noise).

    ``dataload_contention`` models CPU-side input-pipeline pressure (extra
    s/batch × concurrency) — FedScale's bottleneck (§2.5/A.5).
    """
    g = GPUS[gpu_type]
    base = g.a * x + g.b * np.log(g.c * x) + g.d
    base = max(base, 1e-3) * task.time_scale
    base *= concurrency ** g.conc_alpha
    base += dataload_contention * x * concurrency
    sigma = g.noise + (g.small_noise if x < g.small_x else 0.0)
    return float(base * rng.lognormal(0.0, sigma))


def agg_time(n_models: int, model_bytes: float,
             rate: float = AGG_RATE_FEDAVG) -> float:
    """Server-side aggregation duration (Tables 6/7 scaling)."""
    return rate * n_models * model_bytes


def _comm(model_bytes: float) -> float:
    return NET_LATENCY + model_bytes / NET_BW


def simulate_pull_round(rng, task: TaskProfile, workers: list[Worker],
                        client_sizes: list[int], *,
                        dataload_contention: float = 0.0,
                        per_client_overhead: float = 0.0,
                        partial_agg: bool = False,
                        agg_rate: float = AGG_RATE_FEDAVG) -> RoundStats:
    """Fig. 5a: synchronized queue; each worker pulls the next client and
    pays download+upload per client."""
    queue = list(client_sizes)
    qi = 0
    heap = [(0.0, w.wid) for w in workers]
    heapq.heapify(heap)
    by_wid = {w.wid: w for w in workers}
    busy: dict[int, float] = {}
    finish: dict[int, float] = {w.wid: 0.0 for w in workers}
    comm_total = 0.0
    bytes_moved = 0.0
    while qi < len(queue):
        t, wid = heapq.heappop(heap)
        w = by_wid[wid]
        x = queue[qi]
        qi += 1
        c = _comm(task.model_bytes) * 2          # download + upload
        tr = client_time(rng, task, w.gpu_type, x, w.concurrency,
                         dataload_contention=dataload_contention)
        tr += per_client_overhead
        busy[w.gpu_idx] = busy.get(w.gpu_idx, 0.0) + tr
        comm_total += c
        bytes_moved += 2 * task.model_bytes
        t_new = t + c + tr
        finish[wid] = t_new
        heapq.heappush(heap, (t_new, wid))
    makespan = max(finish.values()) if finish else 0.0
    a = agg_time(len(workers) if partial_agg else len(client_sizes),
                 task.model_bytes, agg_rate)
    idle = sum(makespan - f for f in finish.values())
    wall = makespan + a
    return RoundStats(wall_time=wall, busy_per_gpu=busy,
                      idle_time=idle, comm_time=comm_total, agg_time=a,
                      bytes_moved=bytes_moved, n_clients=len(client_sizes),
                      per_worker_finish=finish,
                      gpu_utilization=_utilization(task, workers, busy,
                                                   finish, wall),
                      vram_fraction=_vram_fraction(task, workers))


def simulate_push_round(rng, task: TaskProfile, workers: list[Worker],
                        assignment: dict, *,
                        dataload_contention: float = 0.0,
                        partial_agg: bool = True,
                        agg_rate: float = AGG_RATE_FEDAVG,
                        n_nodes: int = 1) -> RoundStats:
    """Fig. 5b: one-shot placement ``assignment[wid] = [x, ...]``; one model
    copy per node down, one partial (or all client models) up per node."""
    by_wid = {w.wid: w for w in workers}
    busy: dict[int, float] = {}
    finish: dict[int, float] = {}
    n_clients = 0
    for wid, xs in assignment.items():
        w = by_wid[wid]
        total = 0.0
        for x in xs:
            total += client_time(rng, task, w.gpu_type, x, w.concurrency,
                                 dataload_contention=dataload_contention)
        busy[w.gpu_idx] = busy.get(w.gpu_idx, 0.0) + total
        finish[wid] = total
        n_clients += len(xs)
    # one model down per node; uploads: one partial per node, or all clients
    comm = n_nodes * _comm(task.model_bytes)
    up_models = n_nodes if partial_agg else n_clients
    comm += up_models * _comm(task.model_bytes)
    bytes_moved = (n_nodes + up_models) * task.model_bytes
    makespan = max(finish.values()) if finish else 0.0
    a = agg_time(up_models, task.model_bytes, agg_rate)
    idle = sum(makespan - f for f in finish.values())
    wall = makespan + comm + a
    return RoundStats(wall_time=wall, busy_per_gpu=busy,
                      idle_time=idle, comm_time=comm, agg_time=a,
                      bytes_moved=bytes_moved, n_clients=n_clients,
                      per_worker_finish=finish,
                      gpu_utilization=_utilization(task, workers, busy,
                                                   finish, wall),
                      vram_fraction=_vram_fraction(task, workers))
