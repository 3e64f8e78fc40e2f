"""The Pollen round engine (host-side orchestration; paper Fig. 6) — port of
the fused path of ``repro/core/engine.py``.

Per round:
  1. ``WorkerPool.advance_to(t)`` applies elastic fail/join events;
  2. the time model is refit (data <= t-2) and the sampler draws a cohort;
  3. optional deadline trim drops predicted stragglers;
  4. the placement strategy one-shot assigns clients to workers;
  5. synthetic telemetry for the assignment is drawn and observed;
  6. the vectorized packer fills reusable (pinned, on CUDA) host buffers at
     the S-bucketed size and copies them to the device asynchronously;
  7. the round step trains every lane and partially aggregates on the
     device, through a counted :class:`~repro_torch.fl.round
     .StepCompileCache`.

Pipelining (``EngineConfig.pipeline_depth``) is the reference's:
``depth = 0`` is a synchronous loop; ``depth >= 1`` runs steps 1–6 for
rounds t+1 .. t+depth on one producer thread while the consumer executes
round t.  Every host-state mutation lives in the producer, in round order,
and the round step's numbers depend only on its inputs, so losses are
bit-identical across depths.  The host buffers form a ring of ``depth + 1``
slot sets (:class:`~repro_torch.data.batching.PackBuffers`): slot k is only
rewritten for round t+depth+1, which the consumer submits after it has
synced on round t's loss — by then round t's copies out of that slot, which
run on the same CUDA stream before round t's compute, are done.

Not ported yet, and refused with ``NotImplementedError`` rather than
ignored: mesh workers, the device batch cache, the control plane,
compressed and host-hierarchy combines, the gather strategies, and
checkpoints (ROADMAP M9–M14).
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.aggregation import AGG_IMPLS
from repro_torch.core.placement import (Assignment, ClientInfo,
                                        LearningBasedPlacement, Placement)
from repro_torch.data.batching import (PackBuffers, RoundArrays,
                                       build_round_arrays, padding_stats,
                                       plan_round)
from repro_torch.fl.round import StepCompileCache, make_round_step
from repro_torch.fl.strategy import FedAvg, Strategy
from repro_torch.obs import NULL_TRACER, critique_round

__all__ = ["s_bucket", "RoundResult", "EngineConfig", "FederatedEngine"]


def s_bucket(s: int, *, base: int = 8) -> int:
    """Round S up to {base, base*1.5, base*2, ...}: O(log S) distinct round
    shapes, padding strictly < 1.5x."""
    if s <= base:
        return base
    b = base
    while True:
        for m in (1.0, 1.5):
            cand = int(b * m)
            if s <= cand:
                return cand
        b *= 2


def _slo_percentiles(rows) -> tuple[float, float]:
    """p50/p99 of the per-client round times in ``rows`` ([(type, x, t_c)])."""
    if not rows:
        return 0.0, 0.0
    ts = np.asarray([r[2] for r in rows], dtype=np.float64)
    p50, p99 = np.percentile(ts, [50.0, 99.0])
    return float(p50), float(p99)


def _pinned_zeros(shape, dtype) -> np.ndarray:
    """Zeroed page-locked host memory, as a numpy view (the pack buffers'
    allocator on CUDA: copies out of pinned memory run asynchronously)."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    buf = torch.zeros(nbytes, dtype=torch.uint8, pin_memory=True)
    return buf.numpy().view(dtype).reshape(shape)


@dataclass
class RoundResult:
    round_idx: int
    loss: float
    n_clients: int
    makespan: float          # simulated wall time of the slowest worker
    idle_time: float         # paper Table 2 metric
    useful_fraction: float   # padding efficiency of the round step
    wall_time: float         # actual host wall time of the round
    placement: str
    s_steps: int
    pack_time: float = 0.0         # host time packing this round's arrays
    overlap_fraction: float = 0.0  # fraction of pack hidden under execution
    recompiles: int = 0            # distinct round shapes met so far
    exec_time: float = 0.0         # dispatch -> loss sync, host seconds
    padded_steps: int = 0          # dispatched-but-masked lane steps
    slo_p50: float = 0.0           # median per-client round time
    slo_p99: float = 0.0           # tail per-client round time
    idle_fraction: float = 0.0     # idle_time / (makespan * n_workers)
    critical_path: str = ""        # stage bounding this round's wall time


# (field, default, ROADMAP item) of every EngineConfig option this slice
# refuses: a non-default value raises instead of being ignored.
_UNPORTED = (
    ("mesh_workers", 0, "M12"), ("device_cache_batches", 0, "M11"),
    ("device_cache_bytes", 0, "M11"), ("cache_affinity", False, "M11/M12"),
    ("bucket_mode", "round", "M12"), ("combine_mode", "flat", "M12"),
    ("combine_compress", "none", "M13"), ("hosts", 0, "M14"),
    ("telemetry_mode", "synthetic", "M10"), ("barrier_policy", "reuse", "M10"),
    ("drift_threshold", 0.0, "M10"), ("adapt_interval", 0, "M10"),
    ("adapt_granularity", "type", "M10"),
)


@dataclass
class EngineConfig:
    lanes_per_worker: int = 1
    steps_cap: int | None = 64
    s_bucket_base: int = 8
    batch_size: int | None = None
    agg_impl: str = "kernel"      # "kernel" (K1) | "plain" (reference XLA)
    grad_clip: float | None = None
    deadline_rho: float = 0.0     # >0 enables over-sample + trim
    pipeline_depth: int = 1       # 0 = sync; d >= 1 = prep t+1..t+d during t
    compile_cache_size: int = 8   # LRU cap on distinct round shapes
    # -- options of the reference that this slice refuses (see _UNPORTED) --
    mesh_workers: int = 0
    device_cache_batches: int = 0
    device_cache_bytes: int = 0
    cache_affinity: bool = False
    bucket_mode: str = "round"
    combine_mode: str = "flat"
    combine_compress: str = "none"
    hosts: int = 0
    telemetry_mode: str = "synthetic"
    barrier_policy: str = "reuse"
    drift_threshold: float = 0.0
    adapt_interval: int = 0
    adapt_granularity: str = "type"

    def __post_init__(self):
        depth = self.pipeline_depth
        if not isinstance(depth, int) or depth < 0:
            raise ValueError(
                f"pipeline_depth must be an int >= 0, got {depth!r}")
        if self.agg_impl not in AGG_IMPLS:
            raise ValueError(f"agg_impl must be one of {AGG_IMPLS}, got "
                             f"{self.agg_impl!r}")
        if self.compile_cache_size < 1:
            raise ValueError("compile_cache_size must be >= 1, got "
                             f"{self.compile_cache_size!r}")
        for name, default, item in _UNPORTED:
            value = getattr(self, name)
            # mesh_workers 0 and 1 both mean the one fused program.
            if value != default and not (name == "mesh_workers"
                                         and value == 1):
                raise NotImplementedError(
                    f"{name}={value!r} is not ported yet (ROADMAP {item}); "
                    "this slice runs the fused single-program path")


@dataclass
class _PreparedRound:
    """Everything round t needs, produced (possibly on the producer thread)
    before the device is asked to run it."""

    t: int
    clients: list
    workers: list
    arrays: RoundArrays
    device: tuple            # (batches, step_mask, boundary, weight)
    pack_s: float            # host pack time (plan + gather + scatter)
    makespan: float          # simulated round time (prepare time)
    idle_time: float
    overlap_s: float = 0.0   # portion of pack_s hidden under execution
    exec_t0: float = 0.0     # consumer-set: execution dispatch timestamp
    exec_s: float = 0.0      # consumer-set: dispatch -> loss sync
    padded_steps: int = 0
    slo_p50: float = 0.0
    slo_p99: float = 0.0


class FederatedEngine:
    """Composable engine: dataset x model(loss_fn, params) x optimizer x
    placement x sampler x worker pool (+ telemetry source), on ``device``
    (CUDA unless ``device="cpu"`` is passed).

    ``loss_fn`` follows the round step's contract: lane-stacked params and
    batch in, per-lane losses out.  ``init_params`` may hold tensors or
    numpy arrays; they are copied to ``device``.
    """

    def __init__(self, *, dataset, loss_fn, init_params, optimizer,
                 placement: Placement, sampler, pool, telemetry=None,
                 strategy: Strategy | None = None,
                 config: EngineConfig | None = None, checkpoint_store=None,
                 obs=None, device=None):
        strategy = FedAvg() if strategy is None else strategy
        config = EngineConfig() if config is None else config
        if not strategy.associative:
            raise NotImplementedError(
                f"strategy {strategy.name!r} needs the gather path, which is "
                "not ported yet (ROADMAP M4/M5)")
        if checkpoint_store is not None:
            raise NotImplementedError("checkpoints are not ported yet "
                                      "(ROADMAP M9)")
        self.device = resolve_device(device)
        self.dataset = dataset
        self.loss_fn = loss_fn
        self.params = {k: torch.as_tensor(v).to(self.device)
                       for k, v in init_params.items()}
        self.optimizer = optimizer
        self.placement = placement
        self.sampler = sampler
        self.pool = pool
        self.telemetry = telemetry
        self.strategy = strategy
        self.cfg = config
        self.round_idx = 0
        self.history: list[RoundResult] = []
        # Rounds t .. t+depth are in flight at once: depth+1 slot sets.
        self._pack_buffers = PackBuffers(
            depth=config.pipeline_depth + 1,
            alloc=_pinned_zeros if self.device.type == "cuda" else np.zeros)
        self.obs = obs
        self._tracer = obs.tracer if obs is not None else NULL_TRACER
        self._metrics = obs.metrics if obs is not None else None
        self._round_step = StepCompileCache(
            lambda: make_round_step(loss_fn, optimizer,
                                    agg_impl=config.agg_impl,
                                    grad_clip=config.grad_clip),
            capacity=config.compile_cache_size)
        if obs is not None:
            self._round_step.tracer = self._tracer
            self._round_step.trace_label = "round_step"

    # -- helpers -------------------------------------------------------------
    @property
    def compile_stats(self) -> dict:
        """Counters of the round-step cache (distinct round shapes)."""
        return self._round_step.stats()

    def _s_align(self, s_real: int) -> int:
        return s_bucket(s_real, base=self.cfg.s_bucket_base)

    def _cohort(self, t: int) -> list[ClientInfo]:
        if self.cfg.deadline_rho > 0:
            from repro_torch.distributed.elastic import (deadline_trim,
                                                         oversample_cohort)
            ids = oversample_cohort(self.sampler, t, rho=self.cfg.deadline_rho)
            clients = [self._client_info(int(c)) for c in ids]
            predict = None
            if isinstance(self.placement, LearningBasedPlacement) and self.placement.models:
                ms = [m for m in self.placement.models.values() if m.ready]
                if ms:
                    predict = ms[0].predict
            return deadline_trim(clients, self.sampler.cohort_size, predict)
        ids = self.sampler.sample(t)
        return [self._client_info(int(c)) for c in ids]

    def _client_info(self, cid: int) -> ClientInfo:
        return ClientInfo(cid=cid, n_batches=self.dataset.n_batches(cid),
                          n_samples=self.dataset.n_samples(cid))

    def _record_telemetry(self, t: int, assignment: Assignment, workers
                          ) -> tuple[float, float, list]:
        """Draw per-client times for the assignment and feed them to the
        placement model; return (makespan, idle_time, rows) with rows =
        [(type, n_batches, t_c)].  Runs on the producer, in round order."""
        by_wid = {w.wid: w for w in workers}
        loads: dict[int, float] = {}
        rows: list = []
        for wid, clients in assignment.per_worker.items():
            w = by_wid[wid]
            total = 0.0
            for c in clients:
                if self.telemetry is not None:
                    t_c = self.telemetry.sample_time(
                        w.type_name, c.n_batches, concurrency=w.concurrency)
                else:
                    t_c = float(c.n_batches) / max(w.speed, 1e-9)
                total += t_c
                rows.append((w.type_name, c.n_batches, t_c))
            loads[wid] = total / max(w.concurrency, 1)
        makespan = max(loads.values()) if loads else 0.0
        idle = sum(makespan - v for v in loads.values())
        if isinstance(self.placement, LearningBasedPlacement):
            for tname, x, t_c in rows:
                self.placement.observe_type(t, tname, x, t_c)
        return makespan, idle, rows

    def _to_device(self, arrays: RoundArrays) -> tuple:
        """Start the H2D copies of a packed round (async out of pinned
        memory on CUDA; on the CPU the tensors share the pack buffers)."""
        def put(a):
            return torch.from_numpy(a).to(self.device, non_blocking=True)

        return ({k: put(v) for k, v in arrays.batches.items()},
                put(arrays.step_mask), put(arrays.boundary),
                put(arrays.weight))

    # -- the pipeline stages ---------------------------------------------------
    def _prepare_round(self, t: int) -> _PreparedRound:
        """Host-side producer: sample, place, record telemetry, pack, start
        the H2D transfer.  Every host-state mutation lives here."""
        tp0 = time.perf_counter()
        tr = self._tracer
        self.pool.advance_to(t)
        workers = self.pool.snapshot()
        if isinstance(self.placement, LearningBasedPlacement):
            with tr.span("prep.refit", t=t):
                self.placement.refit(t)
        with tr.span("prep.sample", t=t):
            clients = self._cohort(t)
        assignment = self.placement.assign(clients, workers)
        makespan, idle, rows = self._record_telemetry(t, assignment, workers)
        slo_p50, slo_p99 = _slo_percentiles(rows)
        plan = plan_round(assignment, workers,
                          lanes_per_worker=self.cfg.lanes_per_worker,
                          steps_cap=self.cfg.steps_cap, min_steps=1)
        with tr.span("prep.pack", t=t):
            arrays = build_round_arrays(
                self.dataset, plan=plan, batch_size=self.cfg.batch_size,
                s_align=self._s_align, buffers=self._pack_buffers)
        pack_s = time.perf_counter() - tp0
        with tr.span("prep.h2d", t=t):
            device = self._to_device(arrays)
        return _PreparedRound(t=t, clients=clients, workers=workers,
                              arrays=arrays,
                              device=device, pack_s=pack_s,
                              makespan=makespan, idle_time=idle,
                              padded_steps=(arrays.step_mask.size
                                            - plan.n_steps_total),
                              slo_p50=slo_p50, slo_p99=slo_p99)

    def _execute(self, prep: _PreparedRound):
        """Dispatch the round step (async on CUDA); returns its metrics."""
        with self._tracer.span("exec.dispatch", t=prep.t):
            batches, step_mask, boundary, weight = prep.device
            new_params, metrics = self._round_step(
                self.params, batches, step_mask, boundary, weight)
            self.params = new_params
            return metrics

    def _post_execute(self, prep: _PreparedRound, metrics) -> None:
        """Consumer hook at the device sync point: measure execution."""
        with self._tracer.span("exec.wait", t=prep.t):
            float(metrics.loss)                # device sync point
        prep.exec_s = time.perf_counter() - prep.exec_t0

    def _finish(self, prep: _PreparedRound, metrics, t0: float) -> RoundResult:
        """Consumer tail: result bookkeeping."""
        t = prep.t
        loss = float(metrics.loss)
        stats = padding_stats(prep.arrays)
        result = RoundResult(
            round_idx=t, loss=loss, n_clients=len(prep.clients),
            makespan=prep.makespan, idle_time=prep.idle_time,
            useful_fraction=stats["useful_fraction"],
            wall_time=time.perf_counter() - t0,
            placement=self.placement.name, s_steps=prep.arrays.n_steps,
            pack_time=prep.pack_s,
            overlap_fraction=(prep.overlap_s / prep.pack_s
                              if prep.pack_s > 0 else 0.0),
            recompiles=self._round_step.compiles,
            exec_time=prep.exec_s, padded_steps=prep.padded_steps,
            slo_p50=prep.slo_p50, slo_p99=prep.slo_p99)
        crit = critique_round(
            round_idx=t, pack_s=prep.pack_s, overlap_s=prep.overlap_s,
            exec_s=prep.exec_s, makespan=prep.makespan,
            idle_time=prep.idle_time, n_workers=len(prep.workers))
        result.idle_fraction = crit.idle_fraction
        result.critical_path = crit.critical_path
        self.history.append(result)
        self.round_idx = t + 1
        if self._metrics is not None:
            m = self._metrics
            m.inc("rounds")
            m.inc("clients", len(prep.clients))
            m.gauge("loss", loss)
            m.gauge("idle_fraction", crit.idle_fraction)
            m.gauge("overlap_fraction", result.overlap_fraction)
            m.inc("critical_path." + crit.critical_path)
            m.observe("round_wall_s", result.wall_time)
            m.observe("pack_s", prep.pack_s)
            m.observe("exec_s", prep.exec_s)
        return result

    # -- the round -------------------------------------------------------------
    def run_round(self) -> RoundResult:
        """One fully synchronous round (also the ``pipeline_depth=0`` path)."""
        t0 = time.perf_counter()
        prep = self._prepare_round(self.round_idx)
        prep.exec_t0 = time.perf_counter()
        metrics = self._execute(prep)
        self._post_execute(prep, metrics)
        return self._finish(prep, metrics, t0)

    def _run_pipelined(self, n_rounds: int, *, log_every: int = 0
                       ) -> list[RoundResult]:
        """Bounded producer/consumer round loop: while round t executes on
        the device, one producer thread prepares rounds t+1 .. t+depth.

        Overlap accounting: a prep's hidden fraction is 1 - (consumer stall
        waiting for it) / (its pack time).  If an in-flight prep or the
        round step raises, every round already executed is booked in
        ``history`` before the error surfaces, and queued preps stop at the
        abort guard without touching host state."""
        out: list[RoundResult] = []
        first = self.round_idx
        last = first + n_rounds - 1
        depth = self.cfg.pipeline_depth
        queue: deque = deque()
        aborted = False

        def guarded_prep(t):
            nonlocal aborted
            if aborted:
                raise RuntimeError(f"pipeline aborted before round {t} prep")
            try:
                return self._prepare_round(t)
            except BaseException:
                aborted = True
                raise

        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="pollen-pack") as pool:
            prep = self._prepare_round(first)   # nothing to overlap with yet
            next_t = first + 1
            for t in range(first, last + 1):
                t0 = time.perf_counter()
                while next_t <= min(t + depth, last):
                    queue.append(pool.submit(guarded_prep, next_t))
                    next_t += 1
                try:
                    prep.exec_t0 = time.perf_counter()
                    metrics = self._execute(prep)
                    self._post_execute(prep, metrics)   # device sync point
                except BaseException:
                    aborted = True
                    for fut in queue:
                        fut.cancel()
                    raise
                next_prep, prep_err = None, None
                if queue:
                    w0 = time.perf_counter()
                    try:
                        next_prep = queue.popleft().result()
                    except Exception as e:     # noqa: BLE001
                        # Round t already executed — book it before raising.
                        prep_err = e
                    wait_s = time.perf_counter() - w0
                    if next_prep is not None:
                        next_prep.overlap_s = min(
                            next_prep.pack_s,
                            max(0.0, next_prep.pack_s - wait_s))
                r = self._finish(prep, metrics, t0)
                out.append(r)
                if prep_err is not None:
                    for fut in queue:
                        fut.cancel()
                    raise prep_err
                if log_every and r.round_idx % log_every == 0:
                    self._log_round(r)
                prep = next_prep
        return out

    def run(self, n_rounds: int, *, log_every: int = 0) -> list[RoundResult]:
        if n_rounds <= 0:
            return []
        if self.cfg.pipeline_depth > 0:
            return self._run_pipelined(n_rounds, log_every=log_every)
        out = []
        for _ in range(n_rounds):
            r = self.run_round()
            out.append(r)
            if log_every and r.round_idx % log_every == 0:
                self._log_round(r)
        return out

    @staticmethod
    def _log_round(r: RoundResult) -> None:
        print(f"round {r.round_idx:5d} loss={r.loss:.4f} "
              f"clients={r.n_clients} S={r.s_steps} "
              f"useful={r.useful_fraction:.2%} idle={r.idle_time:.1f}s "
              f"pack={r.pack_time * 1e3:.0f}ms "
              f"exec={r.exec_time * 1e3:.0f}ms "
              f"overlap={r.overlap_fraction:.0%}")
