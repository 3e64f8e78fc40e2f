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
     .StepCompileCache` — or, for a non-associative strategy (FedMedian),
     the gather step returns every lane's model and the strategy reduces
     them in one shot;
  8. every ``rounds_per_checkpoint`` rounds, a checkpoint (with a store).

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

Mesh execution (``EngineConfig.mesh_workers = K >= 2``) is the
reference's: one program per FL worker over K shards (``wid % K``), each
worker's ``[1, P, S]`` block copied to its shard's device, every program
dispatched asynchronously and synced *individually* (a CUDA event per
worker, waited on one thread per shard), then one combine — flat (the
fused step's tail on the concatenated lane partials, bitwise equal to the
fused step), or §3.3's tree (a merge per shard first), optionally with the
host level (``hosts``) or compressed shard uploads (``combine_compress``;
K2 folds int8 payloads).  On one card every shard is that card.

Closed-loop control (``telemetry_mode`` / ``drift_threshold`` /
``adapt_interval`` — :mod:`repro_torch.control`) is the reference's: with
``telemetry_mode="measured"`` the placement model learns from the card's
measured times — the fused round's dispatch-to-loss-sync wall time spread
over its clients by predicted share, or each mesh worker's own sync —
released to the producer through the depth-aware refit barrier
(``barrier_policy`` ``"reuse"`` or ``"stall"``).  The drift detector can
fall placement back to Batches-Based and the hill climber retunes worker
concurrency; both act producer-side in round order, so synthetic-mode runs
stay bit-identical across depths with the controller live.

Checkpoints are the reference's files (:mod:`repro_torch.checkpoint`): the
global model, the sampler (the open-world one included) and
synthetic-telemetry RNG states and the control plane's state, snapshotted
at prepare time, the placement model's rows of booked rounds, and the
compressed combine's residuals, so a resumed run is bitwise the
uninterrupted one at any pipeline depth.

An observability bundle (:mod:`repro_torch.obs`) may ride along: its tracer
books every stage, and its flight recorder keeps the last rounds and dumps
them when a round or the pipeline aborts.

The device batch cache (``device_cache_batches`` / ``device_cache_bytes``;
:mod:`repro_torch.data.device_cache`) is the reference's: the producer
plans each round (per worker against its shard's pool on the mesh path)
and gathers only the missed steps into the pinned ring; the consumer
assembles the round's batches on the device from those rows and the pool,
in place, on the stream the step then runs on.  ``cache_affinity`` swaps
cached clients, load-neutrally, toward the shard that holds their rows;
a shard that loses its last worker hands its rows to the others.  The
reference's batch-donation carve-out has no counterpart: the port donates
nothing, and the step only reads the round base.

The process-per-host harness (:mod:`repro_torch.launch.multihost`) drives
three seams, all ``None`` in process: ``_host_rank`` (this process runs
only its host block's worker programs; the others stay holes),
``_host_exchange`` (the all-gather of host partials, as numpy f32) and
``_round_observer`` (each round's control rows onto the sidecar channel).
"""

from __future__ import annotations

import json
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.compress import CombineCompressor, make_encode_step
from repro_torch.core.aggregation import AGG_IMPLS
from repro_torch.core.placement import (Assignment, ClientInfo,
                                        LearningBasedPlacement, Placement,
                                        apply_cache_affinity)
from repro_torch.core.sampling import restore_sampler, sampler_state
from repro_torch.data.batching import (PackBuffers, RoundArrays,
                                       build_round_arrays, build_round_masks,
                                       gather_content_rows, padding_stats,
                                       plan_round, split_plan_by_worker,
                                       worker_stream_lengths)
from repro_torch.data.device_cache import CachePlan, DeviceBatchCache
from repro_torch.distributed.sharding import HostShardMap, WorkerShardMap
from repro_torch.fl.round import (StepCompileCache, make_combine_step,
                                  make_compressed_combine_step,
                                  make_gather_round_step,
                                  make_host_node_merge_step,
                                  make_payload_decode_step, make_round_step,
                                  make_shard_merge_step,
                                  make_worker_round_step)
from repro_torch.fl.strategy import FedAvg, Strategy
from repro_torch.kernels.layout import (FlatLayout, FlatTree, flatten_tree,
                                        tree_cat, tree_stack,
                                        unflatten_tree)
from repro_torch.launch.mesh import fl_combine_topology
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


def _cat_parts(outs):
    """Concatenate worker/shard ``(theta, n, loss)`` partials along the W
    dim.  Glue only — no arithmetic, so exactness holds."""
    return (tree_cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]), torch.cat([o[2] for o in outs]))


def _first_lane(theta: FlatTree) -> FlatTree:
    """Lane ``[0, 0]`` of a ``[W, P, ...]`` flat tree, params-shaped (a
    merged shard partial is ``[1, 1, ...]``)."""
    return theta.map(lambda f: f[0, 0])


def _moved(x, device):
    """``x`` (a tensor, flat tree, tuple or dict of them) on ``device``."""
    if isinstance(x, FlatTree):
        return x if x.device == device else x.map(lambda f: f.to(device))
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, tuple):
        return tuple(_moved(v, device) for v in x)
    return {k: _moved(v, device) for k, v in x.items()}


def _stack_payloads(mode: str, payloads: list):
    """Stack K shard payloads along a new lead dim, as the compressed
    combine takes them."""
    if mode == "int8":
        return (tree_stack([p[0] for p in payloads]),
                tree_stack([p[1] for p in payloads]))
    return {name: (torch.stack([p[name][0] for p in payloads]),
                   torch.stack([p[name][1] for p in payloads]))
            for name in payloads[0]}


def _partial_to_numpy(part):
    """Wire form of one host's ``(theta, n, loss)`` partial for the
    process-per-host exchange: numpy, pickle-safe, one array per dtype
    group.  numpy has no bf16, so a bf16 buffer crosses as the int16 view
    of its bits; every trip is bit-exact, so the coordinator never perturbs
    the reduction.  ``None`` (an all-holes block) passes through."""
    if part is None:
        return None
    theta, n, loss = part
    flats = {k: (f.view(torch.int16) if f.dtype == torch.bfloat16 else f)
             .cpu().numpy() for k, f in theta.flats.items()}
    return (flats, n.cpu().numpy(), loss.cpu().numpy())


def _partial_from_numpy(layout: FlatLayout, part, device):
    """Inverse of :func:`_partial_to_numpy` over ``layout`` (the group
    dtypes say which int16 arrays are bf16 bits)."""
    flats, n, loss = part
    dtypes = {key: g.dtypes[0] for key, g in zip(layout.keys, layout.groups)}
    theta = {}
    for key, a in flats.items():
        t = torch.from_numpy(a)
        if dtypes[key] == torch.bfloat16:
            t = t.view(torch.bfloat16)
        theta[key] = t.to(device)
    return (layout.views(theta), torch.from_numpy(n).to(device),
            torch.from_numpy(loss).to(device))


def _probe_row_bytes(dataset, *, batch_size=None, seq_len=None) -> int:
    """Bytes of one packed batch row (all leaves), from a one-batch gather."""
    probe = dataset.gather_batches(np.asarray([0]), np.asarray([0]),
                                   batch_size=batch_size, seq_len=seq_len)
    return int(sum(int(np.prod(v.shape[1:])) * v.dtype.itemsize
                   for v in probe.values()))


def _warn(msg: str) -> None:
    """A restore that cannot be exact says so on stdout, as the reference
    does, and goes on."""
    print("warning: " + msg)


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
    cache_hit_rate: float = 0.0    # device-cache step hit rate this round
    cache_bytes_saved: int = 0     # H2D bytes skipped via the device cache
    exec_time: float = 0.0         # dispatch -> loss sync, host seconds
    padded_steps: int = 0          # dispatched-but-masked lane steps
    slo_p50: float = 0.0           # median per-client round time
    slo_p99: float = 0.0           # tail per-client round time
    idle_fraction: float = 0.0     # idle_time / (makespan * n_workers)
    critical_path: str = ""        # stage bounding this round's wall time
    combine_bytes: int = 0         # cross-shard combine transfer (mesh path)
    residual_norm: float = 0.0     # L2 of the error-feedback residuals after
    #                                this round (compressed combine only)
    barrier_stall_s: float = 0.0   # producer stall at the refit barrier
    drift_fallback: bool = False   # placed by the BB fallback (drift alarm)
    affinity_swaps: int = 0        # cache-affinity client swaps this round
    stale_fraction: float = 0.0    # cohort fraction drafted while offline
    online_pool: float = 0.0       # expected online-pool size at sample time
    #                                (0 for closed-registry samplers)


@dataclass
class EngineConfig:
    lanes_per_worker: int = 1
    steps_cap: int | None = 64
    s_bucket_base: int = 8
    batch_size: int | None = None
    seq_len: int | None = None    # token rows per batch (LM tasks)
    agg_impl: str = "kernel"      # "kernel" (K1) | "plain" (reference XLA)
    grad_clip: float | None = None
    deadline_rho: float = 0.0     # >0 enables over-sample + trim
    pipeline_depth: int = 1       # 0 = sync; d >= 1 = prep t+1..t+d during t
    compile_cache_size: int = 8   # LRU cap on distinct round shapes
    rounds_per_checkpoint: int = 25  # with a checkpoint store
    device_cache_batches: int = 0  # device rows kept for hot clients; 0 = off
    device_cache_bytes: int = 0    # the cache's budget in bytes; 0 = off
    # -- mesh execution (per-worker programs) and its combine ---------------
    mesh_workers: int = 0          # 0/1 = one fused program; K >= 2 = one
    #                                program per worker over K shards
    cache_affinity: bool = False   # prefer the shard holding a client's rows
    bucket_mode: str = "round"     # "round": every worker program runs at
    #                                the round's S; "worker": at its own
    combine_mode: str = "flat"     # "flat": one combine over every lane
    #                                partial; "tree": per-shard merge first
    combine_compress: str = "none"  # "none" | "int8" | "topk" shard uploads
    combine_topk_frac: float = 0.05  # fraction of entries topk sends per leaf
    hosts: int = 0                 # H >= 1: shards merge in H host blocks
    #                                through the canonical pairwise tree
    # -- control plane (repro_torch.control): any non-default knob enables it
    telemetry_mode: str = "synthetic"   # "synthetic" | "measured"
    barrier_policy: str = "reuse"       # "reuse" | "stall" (measured mode)
    drift_threshold: float = 0.0        # residual EWMA alarm; 0 = off
    drift_window: int = 16
    adapt_interval: int = 0             # rounds per hill-climb move; 0 = off
    adapt_max_slots: int = 64
    adapt_granularity: str = "type"     # "type" | "worker" (per-wid slots)

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
        for name in ("device_cache_batches", "device_cache_bytes"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, got "
                                 f"{getattr(self, name)!r}")
        self._check_mesh()
        self._check_control()

    @property
    def control_enabled(self) -> bool:
        return (self.telemetry_mode == "measured"
                or self.drift_threshold > 0 or self.adapt_interval > 0)

    def _check_control(self) -> None:
        """The reference's checks of the control-plane knobs
        (``repro/core/engine.py:378-403``), with its messages."""
        if self.adapt_granularity not in ("type", "worker"):
            raise ValueError("adapt_granularity must be 'type' or 'worker', "
                             f"got {self.adapt_granularity!r}")
        if self.telemetry_mode not in ("synthetic", "measured"):
            raise ValueError("telemetry_mode must be 'synthetic' or "
                             f"'measured', got {self.telemetry_mode!r}")
        if self.barrier_policy not in ("reuse", "stall"):
            raise ValueError("barrier_policy must be 'reuse' or 'stall', "
                             f"got {self.barrier_policy!r}")
        if self.barrier_policy == "stall" and self.telemetry_mode != "measured":
            raise ValueError("barrier_policy='stall' requires "
                             "telemetry_mode='measured' (synthetic "
                             "telemetry is drawn at prepare time; there is "
                             "no finish-time barrier to stall on)")
        if self.drift_threshold < 0:
            raise ValueError("drift_threshold must be >= 0, got "
                             f"{self.drift_threshold!r}")
        if self.adapt_interval < 0:
            raise ValueError("adapt_interval must be >= 0, got "
                             f"{self.adapt_interval!r}")

    def _check_mesh(self) -> None:
        """The reference's checks of the mesh, affinity, bucket, combine and
        host options (``repro/core/engine.py:310-377``), with its
        messages."""
        if not isinstance(self.mesh_workers, int) or self.mesh_workers < 0:
            raise ValueError("mesh_workers must be an int >= 0, got "
                             f"{self.mesh_workers!r}")
        if self.cache_affinity:
            if self.mesh_workers < 2:
                raise ValueError(
                    "cache_affinity requires mesh_workers >= 2 (with one "
                    "shard there is no 'other' pool to prefer)")
            if self.device_cache_batches <= 0 and self.device_cache_bytes <= 0:
                raise ValueError(
                    "cache_affinity requires an enabled device cache "
                    "(device_cache_batches or device_cache_bytes)")
        if self.bucket_mode not in ("round", "worker"):
            raise ValueError("bucket_mode must be 'round' or 'worker', "
                             f"got {self.bucket_mode!r}")
        if self.bucket_mode == "worker" and self.mesh_workers < 2:
            raise ValueError(
                "bucket_mode='worker' requires mesh_workers >= 2 (the fused "
                "single-program path has one shared stream length; only the "
                "per-worker mesh programs can compile at their own S)")
        if self.combine_mode not in ("flat", "tree"):
            raise ValueError("combine_mode must be 'flat' or 'tree', "
                             f"got {self.combine_mode!r}")
        if self.combine_mode == "tree" and self.mesh_workers < 2:
            raise ValueError(
                "combine_mode='tree' requires mesh_workers >= 2 (with one "
                "shard there is no shard-local partial merge to run before "
                "the cross-shard combine)")
        if self.combine_compress not in ("none", "int8", "topk"):
            raise ValueError("combine_compress must be 'none', 'int8' or "
                             f"'topk', got {self.combine_compress!r}")
        if self.combine_compress != "none" and self.combine_mode != "tree":
            raise ValueError(
                "combine_compress requires combine_mode='tree' (and hence "
                "mesh_workers >= 2): only the per-shard merged partials of "
                "the hierarchical combine have a shard→root upload to "
                "compress; the flat combine is the exact reference path")
        if not 0.0 < self.combine_topk_frac <= 1.0:
            raise ValueError("combine_topk_frac must be in (0, 1], got "
                             f"{self.combine_topk_frac!r}")
        if not isinstance(self.hosts, int) or self.hosts < 0:
            raise ValueError(f"hosts must be an int >= 0, got {self.hosts!r}")
        if self.hosts >= 1:
            if self.combine_mode != "tree" or self.mesh_workers < 2:
                raise ValueError(
                    "hosts >= 1 requires combine_mode='tree' and "
                    "mesh_workers >= 2: the host level sits above the "
                    "shard-local merges of the hierarchical combine — the "
                    "flat combine and the fused single program have no "
                    "shard partials to group into host blocks")
            if self.mesh_workers % self.hosts != 0:
                raise ValueError(
                    f"hosts ({self.hosts}) must divide mesh_workers "
                    f"({self.mesh_workers}): host blocks are equal "
                    "contiguous shard ranges")
            blk = self.mesh_workers // self.hosts
            if self.hosts >= 2 and blk & (blk - 1):
                raise ValueError(
                    f"shards-per-host ({blk}) must be a power of two for "
                    "hosts >= 2 — only aligned pow2 blocks are exact "
                    "subtrees of the canonical pairwise combine, which is "
                    "what keeps losses bit-identical across host counts")


@dataclass
class _PreparedRound:
    """Everything round t needs, produced (possibly on the producer thread)
    before the device is asked to run it."""

    t: int
    clients: list
    workers: list
    arrays: RoundArrays | None
    device: tuple | None     # (batches, step_mask, boundary, weight) on
    #                          the device — None on the mesh path; with the
    #                          cache, batches are the compact miss rows
    pack_s: float            # host pack time (plan + gather + scatter)
    makespan: float          # simulated round time (prepare time)
    idle_time: float
    overlap_s: float = 0.0   # portion of pack_s hidden under execution
    exec_t0: float = 0.0     # consumer-set: execution dispatch timestamp
    exec_s: float = 0.0      # consumer-set: dispatch -> loss sync
    padded_steps: int = 0
    n_steps_real: int = 0    # unpadded lane steps (throughput accounting)
    shares: list | None = None  # (type, x, pred) attribution weights (measured)
    stall_s: float = 0.0     # producer stall at the refit barrier
    fallback: bool = False   # placed by the drift fallback (BB)
    # -- deadline-SLO metrics, computed producer-side in round order ---------
    slo_p50: float = 0.0
    slo_p99: float = 0.0
    stale_fraction: float = 0.0
    online_pool: float = 0.0
    cache_plan: CachePlan | None = None  # the fused path's cache plan
    affinity_swaps: int = 0  # cache-affinity swap count this round
    # -- mesh execution (per-worker programs) ---------------------------------
    worker_programs: list | None = None
    # [(wid, type_name, shard, device, device_arrays, cache_plan, xs,
    #   pred_s)]; device and device_arrays are None for another host's
    # worker (process-per-host harness), cache_plan None without the cache
    combine_masks: tuple | None = None  # full (mask, boundary, weight)
    worker_times: list | None = None
    # consumer-set: [(wid, type_name, xs, pred_s, meas_s)]
    combine_t0: float = 0.0  # consumer-set: cross-shard combine start
    combine_s: float = 0.0   # combine wall (last worker sync -> loss sync)
    combine_bytes: int = 0   # consumer-set: cross-shard combine transfer
    residual_sq: torch.Tensor | None = None  # consumer-set: device scalar
    residual_norm: float = 0.0  # consumer-set at the loss sync
    # -- checkpoint snapshots, taken at prepare time ------------------------
    sampler_st: dict | None = None     # sampler RNG after this round's draw
    telemetry_st: dict | None = None   # telemetry RNG after its draws
    control_st: dict | None = None     # control plane after this prep


class FederatedEngine:
    """Composable engine: dataset x model(loss_fn, params) x optimizer x
    placement x sampler x worker pool (+ telemetry source), on ``device``
    (CUDA unless ``device="cpu"`` is passed).

    ``loss_fn`` follows the round step's contract: lane-stacked params and
    batch in, per-lane losses out; the params it gets are flat
    ``{path: tensor}`` (:func:`~repro_torch.kernels.layout.flatten_tree`).
    ``init_params`` may hold tensors or numpy arrays, flat or nested (the
    LM's tree); they are copied to ``device``.
    """

    def __init__(self, *, dataset, loss_fn, init_params, optimizer,
                 placement: Placement, sampler, pool, telemetry=None,
                 strategy: Strategy | None = None,
                 config: EngineConfig | None = None, checkpoint_store=None,
                 obs=None, device=None):
        strategy = FedAvg() if strategy is None else strategy
        config = EngineConfig() if config is None else config
        if config.mesh_workers >= 2 and not strategy.associative:
            raise ValueError(
                "mesh_workers >= 2 requires an associative strategy: "
                "the gather path ships every client model and reduces "
                "host-side in one shot — it has no per-worker partials "
                "to combine")
        self.device = resolve_device(device)
        self.dataset = dataset
        self.loss_fn = loss_fn
        # A nested tree runs as its flat {path: leaf} dict; ``params``
        # hands it back nested.
        self._nested = any(isinstance(v, dict) for v in init_params.values())
        params = {k: torch.as_tensor(v).to(self.device)
                  for k, v in flatten_tree(init_params).items()}
        # The global model as one flat buffer per dtype group with per-leaf
        # views: every round program flattens it for free.
        self._layout = FlatLayout(params)
        self.params = params
        self.device = self._params.device         # "cuda" -> "cuda:0"
        self.optimizer = optimizer
        self.placement = placement
        self.sampler = sampler
        self.pool = pool
        self.telemetry = telemetry
        self.strategy = strategy
        self.cfg = config
        self.ckpt = checkpoint_store
        self.round_idx = 0
        self.history: list[RoundResult] = []
        self._sampler_ckpt_state = None
        self._telemetry_ckpt_state = None
        self._control_ckpt_state = None
        # Rounds t .. t+depth are in flight at once: depth+1 slot sets.
        self._pack_buffers = PackBuffers(
            depth=config.pipeline_depth + 1,
            alloc=_pinned_zeros if self.device.type == "cuda" else np.zeros)
        self.obs = obs
        self._tracer = obs.tracer if obs is not None else NULL_TRACER
        self._metrics = obs.metrics if obs is not None else None
        self._ctl_log_seen = 0
        self.control = None
        if config.control_enabled:
            # Deferred import: repro_torch.control imports core.placement,
            # so a module-level import here would cycle through the package.
            from repro_torch.control.controller import (ControlPlane,
                                                        ControllerConfig)
            self.control = ControlPlane(
                ControllerConfig(
                    telemetry_mode=config.telemetry_mode,
                    barrier_policy=config.barrier_policy,
                    drift_threshold=config.drift_threshold,
                    drift_window=config.drift_window,
                    adapt_interval=config.adapt_interval,
                    adapt_max_slots=config.adapt_max_slots,
                    adapt_granularity=config.adapt_granularity),
                placement=placement, pool=pool)
        size = config.compile_cache_size

        def cache(factory):
            return StepCompileCache(factory, capacity=size)

        if strategy.associative:
            self._round_step = cache(
                lambda: make_round_step(loss_fn, optimizer,
                                        agg_impl=config.agg_impl,
                                        grad_clip=config.grad_clip))
            self._gather_step = None
        else:
            # Non-associative: every lane's model goes to the reduce.
            self._gather_step = cache(
                lambda: make_gather_round_step(loss_fn, optimizer,
                                               grad_clip=config.grad_clip))
            self._round_step = None
        # Mesh execution: one program per worker over K shards (0/1 keep
        # the one fused program).  On one device every shard resolves to
        # it and no partial moves; across cards the partials cross to the
        # engine's device, where the global model and the combine live.
        self._mesh_shards = (config.mesh_workers
                             if config.mesh_workers >= 2 else 0)
        self._shard_devices: list = []
        self._worker_step = self._combine_step = self._merge_step = None
        self._host_map = self._host_node_step = self._decode_step = None
        self._compress = self._encode_step = None
        self._compressed_combine_step = None
        self._sync_pool = None
        # One lane partial on the wire: a params-shaped theta plus its
        # weight and loss scalars.
        self._partial_bytes = sum(v.numel() * v.element_size()
                                  for v in params.values()) + 8
        if self._mesh_shards:
            devs, _ = fl_combine_topology(self._mesh_shards, self.device)
            if any(d != devs[0] for d in devs):
                self._shard_devices = devs
            self._worker_step = cache(
                lambda: make_worker_round_step(loss_fn, optimizer,
                                               agg_impl=config.agg_impl,
                                               grad_clip=config.grad_clip))
            self._combine_step = cache(make_combine_step)
            if config.combine_mode == "tree":
                self._merge_step = cache(make_shard_merge_step)
            if config.hosts >= 1:
                self._host_map = HostShardMap.build(self._mesh_shards,
                                                    config.hosts)
                self._host_node_step = cache(make_host_node_merge_step)
                if config.combine_compress != "none":
                    self._decode_step = cache(
                        lambda: make_payload_decode_step(
                            config.combine_compress))
            if config.combine_compress != "none":
                self._compress = CombineCompressor(
                    config.combine_compress, self._params,
                    topk_frac=config.combine_topk_frac)
                self._encode_step = cache(
                    lambda: make_encode_step(config.combine_compress,
                                             config.combine_topk_frac))
                self._compressed_combine_step = cache(
                    lambda: make_compressed_combine_step(
                        config.combine_compress))
            # Persistent per-shard sync pool (engine lifetime), so thread
            # churn stays out of the window measured as exec_time.
            self._sync_pool = ThreadPoolExecutor(
                max_workers=self._mesh_shards,
                thread_name_prefix="pollen-sync")
        # The process-per-host harness's seams (launch/multihost.py): rank
        # r runs only its host block's worker programs and all-gathers host
        # partials through the exchange; the observer ships each round's
        # control rows onto the sidecar channel.  None = in process.
        self._host_rank: int | None = None
        self._host_exchange = None
        self._round_observer = None
        self._device_cache = None
        if config.device_cache_batches > 0 or config.device_cache_bytes > 0:
            row_bytes = 0
            if config.device_cache_bytes > 0:
                # Byte capacity -> rows: probe one batch for the row size
                # (leaf shapes are uniform across clients by construction).
                row_bytes = _probe_row_bytes(dataset,
                                             batch_size=config.batch_size,
                                             seq_len=config.seq_len)
            self._device_cache = DeviceBatchCache(
                config.device_cache_batches,
                capacity_bytes=config.device_cache_bytes,
                row_bytes=row_bytes,
                compile_cache_size=config.compile_cache_size,
                n_shards=self._mesh_shards or 1,
                devices=(fl_combine_topology(self._mesh_shards, self.device)[0]
                         if self._mesh_shards else [self.device]))
        self._caches = {
            "round_step": self._round_step, "gather_step": self._gather_step,
            "worker_step": self._worker_step,
            "combine_step": self._combine_step,
            "merge_step": self._merge_step,
            "host_node_step": self._host_node_step,
            "decode_step": self._decode_step,
            "encode_step": self._encode_step,
            "compressed_combine_step": self._compressed_combine_step}
        if obs is not None:
            for label, c in self._caches.items():
                if c is not None:
                    c.tracer = self._tracer
                    c.trace_label = label
            if self._device_cache is not None:
                self._device_cache.tracer = self._tracer

    # -- helpers -------------------------------------------------------------
    @property
    def compile_stats(self) -> dict:
        """Counters of the step caches (distinct round shapes).  On the
        mesh path the totals fold in every program's cache, each also
        broken out under its own name."""
        main = (self._round_step if self._round_step is not None
                else self._gather_step)
        stats = main.stats()
        for label, c in self._caches.items():
            if c is None or c is main:
                continue
            sub = c.stats()
            for k in ("compiles", "evictions", "hits", "entries"):
                stats[k] += sub[k]
            stats[label] = sub
        return stats

    @property
    def _compiles_total(self) -> int:
        return sum(c.compiles for c in self._caches.values() if c is not None)

    @property
    def cache_stats(self) -> dict:
        """Device-batch-cache counters (``{}`` when the cache is off)."""
        return self._device_cache.stats() if self._device_cache else {}

    @property
    def control_stats(self) -> dict:
        """Control-plane counters (barrier/drift/concurrency; {} when off)."""
        return self.control.stats() if self.control is not None else {}

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

    @staticmethod
    def _accumulate_loads(assignment: Assignment, workers, time_fn
                          ) -> tuple[float, float, list, dict]:
        """Fold ``time_fn(worker, client)`` over the assignment; return
        (makespan, idle_time, rows, loads) with rows = [(type, n_batches,
        t_c)] in iteration order and loads = per-wid concurrency-scaled
        totals (the per-worker predictions the mesh path measures
        against)."""
        by_wid = {w.wid: w for w in workers}
        loads: dict[int, float] = {}
        rows: list = []
        for wid, clients in assignment.per_worker.items():
            w = by_wid[wid]
            total = 0.0
            for c in clients:
                t_c = time_fn(w, c)
                total += t_c
                rows.append((w.type_name, c.n_batches, t_c))
            loads[wid] = total / max(w.concurrency, 1)
        makespan = max(loads.values()) if loads else 0.0
        idle = sum(makespan - v for v in loads.values())
        return makespan, idle, rows, loads

    def _record_telemetry(self, t: int, assignment: Assignment, workers
                          ) -> tuple[float, float, list]:
        """Draw per-client times for the assignment and feed them to the
        placement model; return (makespan, idle_time, rows) with rows =
        [(type, n_batches, t_c)].  Runs on the producer, in round order."""
        def draw(w, c):
            if self.telemetry is not None:
                return self.telemetry.sample_time(w.type_name, c.n_batches,
                                                  concurrency=w.concurrency)
            return float(c.n_batches) / max(w.speed, 1e-9)

        makespan, idle, rows, _ = self._accumulate_loads(assignment, workers,
                                                         draw)
        if isinstance(self.placement, LearningBasedPlacement):
            for tname, x, t_c in rows:
                self.placement.observe_type(t, tname, x, t_c)
        return makespan, idle, rows

    def _predict_round(self, assignment: Assignment, workers
                       ) -> tuple[float, float, list, dict]:
        """Measured mode's prepare-time half: PREDICT per-client times (no
        synthetic draw, no ``observe``) and return the shares the consumer
        spreads the measured round time over, plus the per-wid predicted
        loads.  Batch-count/speed proxies stand in until the per-type model
        is ready."""
        models = (self.placement.models
                  if isinstance(self.placement, LearningBasedPlacement)
                  else {})

        def predict(w, c):
            m = models.get(w.type_name)
            if m is not None and m.ready:
                return float(m.predict(float(c.n_batches)))
            return float(c.n_batches) / max(w.speed, 1e-9)

        return self._accumulate_loads(assignment, workers, predict)

    @staticmethod
    def _put(a: np.ndarray, device) -> torch.Tensor:
        """Start the H2D copy of a packed array (async out of pinned memory
        on CUDA; on the CPU the tensor shares the pack buffer)."""
        return torch.from_numpy(a).to(device, non_blocking=True)

    def _to_device(self, batches: dict, arrays: RoundArrays) -> tuple:
        """Start the H2D copies of a packed round (``batches`` are the
        compact miss rows on the cache path)."""
        def put(a):
            return self._put(a, self.device)

        return ({k: put(v) for k, v in batches.items()},
                put(arrays.step_mask), put(arrays.boundary),
                put(arrays.weight))

    # -- the pipeline stages ---------------------------------------------------
    def _prepare_round(self, t: int) -> _PreparedRound:
        """Host-side producer: sample, place, record telemetry, pack, start
        the H2D transfer.  Every host-state mutation lives here — pool
        events, the control plane's barrier flush, drift and slot moves,
        sampler RNG, refit, telemetry — in round order."""
        tp0 = time.perf_counter()
        tr = self._tracer
        fired = self.pool.advance_to(t)
        ctl = self.control
        stall_s, fallback = 0.0, False
        if ctl is not None:
            if fired:
                ctl.on_pool_events(t, fired)
            # The closed loop's producer half: flush barrier-released
            # measured rows into the model ("stall" blocks here until round
            # t-2 has finished), update drift, apply pending slot moves.
            with tr.span("prep.barrier", t=t):
                pre = ctl.pre_round(t)
            stall_s, fallback = pre.stall_s, pre.fallback
        workers = self.pool.snapshot()
        if isinstance(self.placement, LearningBasedPlacement):
            with tr.span("prep.refit", t=t):
                self.placement.refit(t)
        with tr.span("prep.sample", t=t):
            clients = self._cohort(t)
        sampler_st = sampler_state(self.sampler)
        place = ctl.fallback_placement if fallback else self.placement
        assignment = place.assign(clients, workers)
        mesh_map, n_swaps = None, 0
        cache = self._device_cache
        if self._mesh_shards:
            mesh_map = WorkerShardMap.build(workers, self._mesh_shards,
                                            devices=self._shard_devices)
            if cache is not None:
                # Orphan-shard reclamation: a shard whose last worker died
                # hands its row budget to the survivors (and gets it back
                # on a rejoin) — here, in round order, so the LRU's
                # consequences are the same at any depth.
                ev = cache.rebalance(mesh_map.live_shards())
                if ev is not None and ctl is not None:
                    ctl.on_cache_rebalance(t, ev)
            if self.cfg.cache_affinity:
                # Load-neutral swaps (equal batch count, equal worker type)
                # toward the live shard that already holds a client's rows.
                # Under the process-per-host harness a rank's cache holds
                # only its own shards, so ranks can swap differently (as in
                # the reference): launch/multihost.py does not support it.
                assignment, n_swaps = apply_cache_affinity(
                    assignment, workers, mesh_map.shard_of_wid,
                    cache.shard_for_client,
                    live_shards=mesh_map.live_shards())
        shares, loads = None, {}
        if self.cfg.telemetry_mode == "measured":
            makespan, idle, shares, loads = self._predict_round(assignment,
                                                                workers)
            time_rows = shares
            if self._mesh_shards:
                # Each worker program is synced on its own: worker times are
                # measured, and the predicted-share attribution is unused.
                shares = None
        else:
            makespan, idle, time_rows = self._record_telemetry(
                t, assignment, workers)
            if ctl is not None:
                ctl.round_prepared(t, makespan=makespan,
                                   n_clients=len(clients), rows=time_rows)
        slo_p50, slo_p99 = _slo_percentiles(time_rows)
        # The online-pool stats the sampler published for THIS round's draw
        # (same thread, read at once: depth-invariant).
        pop_stats = getattr(self.sampler, "last_stats", None) or {}
        # Snapshot the synthetic-telemetry RNG AFTER this round's draws
        # (mirrors the sampler snapshot): the checkpoint for round_idx = t+1
        # resumes the stream where round t left it, however far ahead the
        # pipelined producer has drawn.  The control plane likewise, after
        # every control mutation of this round.
        telemetry_st = (self.telemetry.state_dict()
                        if hasattr(self.telemetry, "state_dict") else None)
        control_st = ctl.state_dict() if ctl is not None else None
        if ctl is not None and tr.enabled:
            # Controller decisions become instants by diffing its log.
            log = ctl.log
            for rnd, kind, detail in log[self._ctl_log_seen:]:
                tr.instant("ctl." + str(kind), round=int(rnd),
                           detail=str(detail))
            self._ctl_log_seen = len(log)
            if fallback:
                tr.instant("ctl.drift_fallback", round=t)
        plan = plan_round(assignment, workers,
                          lanes_per_worker=self.cfg.lanes_per_worker,
                          steps_cap=self.cfg.steps_cap, min_steps=1)
        prep = _PreparedRound(t=t, clients=clients, workers=workers,
                              arrays=None, device=None, pack_s=0.0,
                              makespan=makespan, idle_time=idle,
                              n_steps_real=plan.n_steps_total,
                              shares=shares, stall_s=stall_s,
                              fallback=fallback,
                              slo_p50=slo_p50, slo_p99=slo_p99,
                              stale_fraction=float(
                                  pop_stats.get("stale_fraction", 0.0)),
                              online_pool=float(
                                  pop_stats.get("online_pool", 0.0)),
                              sampler_st=sampler_st,
                              telemetry_st=telemetry_st,
                              control_st=control_st,
                              affinity_swaps=n_swaps)
        if mesh_map is not None:
            # One program per worker: the round packs once at its full
            # [W, P, S] size and each worker's block is sliced out for its
            # own copy; the full masks also go over once, for the combine.
            S = self._s_align(plan.s_real)
            if self.cfg.bucket_mode == "worker":
                worker_S = [self._s_align(int(s))
                            for s in worker_stream_lengths(plan)]
            else:
                worker_S = [S] * plan.W
            with tr.span("prep.pack", t=t, S=S, W=plan.W):
                if cache is not None:
                    prep.arrays = build_round_masks(
                        plan, S, buffers=self._pack_buffers)
                else:
                    prep.arrays = build_round_arrays(
                        self.dataset, plan=plan,
                        batch_size=self.cfg.batch_size,
                        seq_len=self.cfg.seq_len, s_align=lambda s: S,
                        buffers=self._pack_buffers)
                prep.worker_programs = self._pack_worker_programs(
                    t, plan, worker_S, prep.arrays, assignment, workers,
                    mesh_map, loads)
            prep.pack_s = time.perf_counter() - tp0
            prep.padded_steps = (int(sum(worker_S)) * plan.P
                                 - plan.n_steps_total)
            with tr.span("prep.h2d", t=t):
                a = prep.arrays
                prep.combine_masks = tuple(
                    self._put(x, self.device)
                    for x in (a.step_mask, a.boundary, a.weight))
            return prep
        with tr.span("prep.pack", t=t):
            if cache is not None:
                # Cache path: no full-size host batch buffer at all — the
                # masks as usual, and the content as compact miss rows the
                # consumer assembles on the device (misses + pool hits).
                S = self._s_align(plan.s_real)
                prep.cache_plan = cache.plan(plan, S, t)
                prep.arrays = build_round_masks(plan, S,
                                                buffers=self._pack_buffers)
                host_batches = gather_content_rows(
                    self.dataset, plan, prep.cache_plan.content_mask,
                    prep.cache_plan.n_miss_rows,
                    batch_size=self.cfg.batch_size, seq_len=self.cfg.seq_len,
                    buffers=self._pack_buffers)
            else:
                prep.arrays = build_round_arrays(
                    self.dataset, plan=plan, batch_size=self.cfg.batch_size,
                    seq_len=self.cfg.seq_len, s_align=self._s_align,
                    buffers=self._pack_buffers)
                host_batches = prep.arrays.batches
        prep.pack_s = time.perf_counter() - tp0
        prep.padded_steps = prep.arrays.step_mask.size - plan.n_steps_total
        with tr.span("prep.h2d", t=t):
            prep.device = self._to_device(host_batches, prep.arrays)
        return prep

    def _pack_worker_programs(self, t, plan, worker_S, arrays, assignment,
                              workers, mesh_map, loads: dict) -> list:
        """Producer half of the mesh path: each worker's ``[1, P, S_w]``
        block, copied to its shard's device.

        ``worker_S[wi]`` is the round's S (``bucket_mode="round"``) or the
        worker's own bucket (``"worker"``: a short worker skips its
        trailing padded steps).  A block at the round's S is a contiguous
        slice of the pinned ring and copies asynchronously; a shorter one
        is a strided view, which PyTorch stages through pageable memory
        before the copy (same values, a blocking copy on this thread).
        With the device cache on, each worker's content travels as its own
        compact miss rows (a contiguous ring slot), planned against its
        shard's pool at that worker's S."""
        subplans = (split_plan_by_worker(plan)
                    if self._device_cache is not None else None)
        slot_counts: dict[int, int] = {}
        programs = []
        for wi, w in enumerate(sorted(workers, key=lambda w: w.wid)):
            shard = mesh_map.shard_of(w.wid)
            slot = slot_counts.get(shard, 0)
            slot_counts[shard] = slot + 1
            xs = [c.n_batches for c in assignment.per_worker.get(w.wid, [])]
            pred = float(loads.get(w.wid, 0.0))
            if (self._host_rank is not None
                    and self._host_map.host_of(shard) != self._host_rank):
                # Process-per-host harness: another host owns this shard.
                # Everything above ran here too (every rank's producer
                # state agrees); the copies and the program are that
                # host's.  The entry keeps the positions aligned.
                programs.append((w.wid, w.type_name, shard, None, None, None,
                                 xs, pred))
                continue
            dev = mesh_map.device_for(w.wid) or self.device
            S_w = worker_S[wi]

            def put(a):
                return self._put(a[wi:wi + 1, :, :S_w], dev)

            masks = (put(arrays.step_mask), put(arrays.boundary),
                     put(arrays.weight))
            cplan = None
            if self._device_cache is not None:
                cplan = self._device_cache.plan(subplans[wi], S_w, t,
                                                shard=shard, worker_slot=slot)
                miss = gather_content_rows(
                    self.dataset, subplans[wi], cplan.content_mask,
                    cplan.n_miss_rows, batch_size=self.cfg.batch_size,
                    seq_len=self.cfg.seq_len, buffers=self._pack_buffers,
                    tag=wi)
                batches = {k: self._put(v, dev) for k, v in miss.items()}
            else:
                batches = {k: put(v) for k, v in arrays.batches.items()}
            programs.append((w.wid, w.type_name, shard, dev,
                             (batches, *masks), cplan, xs, pred))
        return programs

    def _execute(self, prep: _PreparedRound):
        """Dispatch the round step (async on CUDA); returns its metrics."""
        if prep.worker_programs is not None:
            return self._execute_mesh(prep)
        with self._tracer.span("exec.dispatch", t=prep.t):
            batches, step_mask, boundary, weight = prep.device
            if prep.cache_plan is not None:
                # The compact miss rows and the pool become the round's
                # batches, in place, ahead of the step on this stream.
                batches = self._device_cache.apply(batches, prep.cache_plan)
            if self._gather_step is None:
                self._params, metrics = self._round_step(
                    self._params, batches, step_mask, boundary, weight)
                return metrics
            stacked, ws, metrics = self._gather_step(
                self._params, batches, step_mask, boundary, weight)
            # Coordinate-wise reduces see the [W·P, n_g] models of each
            # dtype group as one leaf.
            self._params = self._layout.views(self.strategy.reduce(
                stacked, ws, self._params.flats))
            return metrics

    @property
    def params(self) -> dict:
        """The global model in the form it was given: ``{name: tensor}``
        or the nested tree, its leaves views of one flat buffer.  The dicts
        are read-only; assigning a new tree replaces the model."""
        if self._nested:
            return unflatten_tree(self._params)
        return self._params

    @params.setter
    def params(self, value: dict) -> None:
        if not (isinstance(value, FlatTree) and value.layout == self._layout):
            value = flatten_tree(value)
            value = self._layout.views(self._layout.flatten_groups(
                {k: torch.as_tensor(value[k]).to(self.device)
                 for k in self._layout.names}))
        self._params = value

    def _params_on(self, device, cache: dict) -> FlatTree:
        """The global model on ``device`` (copied once per round)."""
        if device == self._params.device:
            return self._params
        if device not in cache:
            cache[device] = _moved(self._params, device)
        return cache[device]

    def _to_root(self, x):
        """A shard's partial or payload on the engine's device (the combine
        root); a no-op on one device."""
        return _moved(x, self.device) if self._shard_devices else x

    def _execute_mesh(self, prep: _PreparedRound):
        """Mesh consumer half: dispatch every worker's program (async), sync
        each one INDIVIDUALLY — a CUDA event per worker, waited on one
        thread per shard — then combine the partials."""
        tr = self._tracer
        cache = self._device_cache
        dispatched = []
        on_dev: dict = {}
        shard_slots: dict[int, int] = {}

        def run(block, cplan, params):
            if cplan is not None:
                block = (cache.apply(block[0], cplan), *block[1:])
            return self._worker_step(params, *block)

        for wid, tname, shard, dev, block, cplan, xs, pred in \
                prep.worker_programs:
            if block is None:
                # Another host's shard (process-per-host harness): its
                # owner runs it and ships the merged host partial instead.
                continue
            if cplan is not None:
                shard_slots[shard] = max(shard_slots.get(shard, 0),
                                         cplan.worker_slot + 1)
            params = self._params_on(dev, on_dev)
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    out = run(block, cplan, params)
                    done = torch.cuda.Event()
                    done.record()
            else:
                out, done = run(block, cplan, params), None
            dispatched.append((wid, tname, shard, xs, pred, out, done))
        if cache is not None:
            # Elastic churn can shrink (or empty) a shard's worker set:
            # retire the departed slots' round bases, or they stay resident
            # for the rest of the run.
            for s in range(cache.n_shards):
                cache.retire_slots(s, shard_slots.get(s, 0))
        # Each shard's programs run in order on its device, so a worker's
        # time is the delta from its shard-mate's completion.  Shards sync
        # on their own threads: blocking on a slow shard from one thread
        # would charge its time to every worker not yet observed elsewhere.
        # On one card all programs serialize and the deltas approximate the
        # target topology.
        t0 = prep.exec_t0
        by_shard: dict[int, list] = {}
        for i, (wid, _, shard, _, _, _, done) in enumerate(dispatched):
            by_shard.setdefault(shard, []).append((i, wid, done))
        meas = [0.0] * len(dispatched)

        def sync_shard(chain):
            last = t0
            for i, wid, done in chain:
                if done is not None:
                    done.synchronize()
                now = time.perf_counter()
                meas[i] = max(now - last, 0.0)
                if tr.enabled:
                    tr.add_span("exec.sync", last, now - last,
                                lane=f"worker{wid}", wid=int(wid), t=prep.t)
                last = now

        if len(by_shard) > 1:
            list(self._sync_pool.map(sync_shard, by_shard.values()))
        else:
            for chain in by_shard.values():
                sync_shard(chain)
        prep.worker_times = [(wid, tname, xs, pred, meas[i]) for i, (
            wid, tname, _, xs, pred, _, _) in enumerate(dispatched)]
        # The combine's wall starts here and ends at the loss sync.
        prep.combine_t0 = time.perf_counter()
        if self._merge_step is None:
            # Flat: every lane partial crosses, and the combine is exactly
            # the fused step's tail on the concatenated [W·P, N] partials.
            theta_wp, n_wp, lane_losses = _cat_parts(
                [self._to_root(d[5]) for d in dispatched])
            prep.combine_bytes = n_wp.numel() * self._partial_bytes
            return self._combine(prep, theta_wp, n_wp, lane_losses)
        by_group: dict[int, list] = {}
        for d in dispatched:
            by_group.setdefault(d[2], []).append(d[5])
        merged = {shard: self._merge_shard(outs)
                  for shard, outs in sorted(by_group.items())}
        if self._host_map is not None:
            return self._combine_hosts(prep, merged, on_dev)
        if self._compress is not None:
            return self._combine_compressed(prep, merged, on_dev)
        # Tree: one merged partial per shard crosses to the combine.
        theta_wp, n_wp, lane_losses = _cat_parts(
            [self._to_root(m) for m in merged.values()])
        prep.combine_bytes = len(merged) * self._partial_bytes
        return self._combine(prep, theta_wp, n_wp, lane_losses)

    def _merge_shard(self, outs: list) -> tuple:
        """A shard's lane partials merged into one ``[1, 1, ...]`` partial,
        on the shard's device."""
        th, n_s, ls_s = _cat_parts(outs)
        merge = self._merge_step.lookup(tuple(n_s.shape))
        return merge(th, n_s, ls_s)

    def _combine(self, prep, theta_wp, n_wp, lane_losses):
        """The cross-shard combine over stacked ``[W, P, ...]`` partials."""
        step_mask, boundary, weight = prep.combine_masks
        fn = self._combine_step.lookup(tuple(n_wp.shape)
                                       + tuple(step_mask.shape))
        self._params, metrics = fn(self._params, theta_wp, n_wp, lane_losses,
                                   step_mask, boundary, weight)
        return metrics

    def _encode(self, shard: int, merged: tuple, on_dev: dict, staged: dict):
        """Delta-encode a shard's merged partial through its error-feedback
        residual (on the shard's device); stages the new residual."""
        theta = _first_lane(merged[0])
        dev = theta.device
        encode = self._encode_step.lookup(("encode",))
        payload, staged[shard] = encode(
            self._params_on(dev, on_dev), theta,
            _moved(self._compress.residual(shard), dev))
        return payload

    def _commit_residuals(self, prep, staged: dict) -> None:
        """Adopt the round's residuals once the combine is dispatched; the
        norm stays on the device until the round's loss sync."""
        self._compress.commit(staged)
        prep.residual_sq = self._compress.residual_sq_sum()

    def _combine_compressed(self, prep, merged: dict, on_dev: dict):
        """Compressed combine tail (``combine_compress`` = ``int8``/
        ``topk``): each shard's merged partial is delta-encoded, only the
        payloads cross, and the compressed combine folds them (one K2
        launch per int8 payload).  ``combine_bytes`` counts the compressed
        wire format; the weight and loss scalars stay exact."""
        staged: dict = {}
        payloads, ns, losses = [], [], []
        for shard, m in merged.items():
            payloads.append(self._to_root(
                self._encode(shard, m, on_dev, staged)))
            ns.append(self._to_root(m[1][0, 0]))
            losses.append(self._to_root(m[2][0, 0]))
        prep.combine_bytes = len(payloads) * self._compress.payload_bytes
        step_mask, boundary, weight = prep.combine_masks
        fn = self._compressed_combine_step.lookup(
            (len(payloads),) + tuple(step_mask.shape))
        self._params, metrics = fn(
            self._params, _stack_payloads(self._compress.mode, payloads),
            torch.stack(ns), torch.stack(losses), step_mask, boundary,
            weight)
        self._commit_residuals(prep, staged)
        return metrics

    def _combine_hosts(self, prep, merged: dict, on_dev: dict):
        """Host-hierarchy combine tail (``hosts >= 1``): the K positional
        shard slots reduce through the canonical pairwise tree — each host
        block (an aligned pow2 subtree; dead shards stay ``None`` holes),
        then the root over one partial per host.  ``combine_bytes`` counts
        the host→root hop: ``live_hosts * partial_bytes``.

        With ``combine_compress`` on, each shard's partial is still encoded
        per shard (payloads and residuals do not depend on the host count)
        and decoded to a dense partial before the pairwise nodes."""
        hm = self._host_map
        tr = self._tracer
        own = self._host_rank
        nfn = self._host_node_step.lookup(("node",))

        def node(a, b):
            return nfn(*a, *b)

        staged: dict = {}
        slots: list = [None] * hm.n_shards
        for shard, m in merged.items():
            theta = _first_lane(m[0])
            if self._compress is not None:
                payload = self._encode(shard, m, on_dev, staged)
                decode = self._decode_step.lookup(("decode",))
                theta = decode(self._params_on(theta.device, on_dev),
                               payload)
            slots[shard] = self._to_root((theta, m[1][0, 0], m[2][0, 0]))
        host_parts: list = [None] * hm.n_hosts
        for h in range(hm.n_hosts):
            if own is not None and h != own:
                continue
            t0h = time.perf_counter()
            part = HostShardMap.pairwise_reduce(
                slots[h * hm.block:(h + 1) * hm.block], node)
            if part is not None and tr.enabled:
                tr.add_span("exec.host_merge", t0h,
                            time.perf_counter() - t0h, lane=f"host{h}",
                            host=h, t=prep.t)
            host_parts[h] = part
        if self._host_exchange is not None:
            # Every rank gets every host's partial and runs the same root
            # reduction, so params stay bitwise equal on every host.
            # Decoded partials are the f32 twin of the params.
            layout = (self._layout if self._compress is None
                      else self._layout.twin)
            gathered = self._host_exchange(
                prep.t, own, _partial_to_numpy(host_parts[own]))
            for h, p in enumerate(gathered):
                if h != own and p is not None:
                    host_parts[h] = _partial_from_numpy(layout, p,
                                                        self.device)
        live = sum(1 for p in host_parts if p is not None)
        if live == 0:
            raise RuntimeError(f"round {prep.t}: no live shard partials "
                               "reached the host combine")
        prep.combine_bytes = live * self._partial_bytes
        theta, n, loss = HostShardMap.pairwise_reduce(host_parts, node)
        metrics = self._combine(
            prep, theta.map(lambda f: f.reshape(1, 1, -1)),
            n.reshape(1, 1), loss.reshape(1, 1))
        if self._compress is not None:
            self._commit_residuals(prep, staged)
        return metrics

    def _post_execute(self, prep: _PreparedRound, metrics) -> None:
        """Consumer hook at the device sync point: measure execution (on
        the mesh path the combine's share of it) and — with the control
        plane on — hand the measurement to it and mark the round finished
        for the refit barrier.  That is what wakes a stalled producer, so
        it runs before any queue wait."""
        with self._tracer.span("exec.wait", t=prep.t):
            float(metrics.loss)                # device sync point
        now = time.perf_counter()
        prep.exec_s = now - prep.exec_t0
        if prep.combine_t0 > 0.0:
            prep.combine_s = max(now - prep.combine_t0, 0.0)
            if self._tracer.enabled:
                self._tracer.add_span(
                    "exec.combine", prep.combine_t0, prep.combine_s,
                    t=prep.t, mode=self.cfg.combine_mode,
                    compress=self.cfg.combine_compress,
                    bytes=int(prep.combine_bytes))
        if prep.residual_sq is not None:
            prep.residual_norm = float(prep.residual_sq.sqrt())
        if self.control is not None:
            if prep.residual_sq is not None:
                self.control.on_combine_compressed(
                    prep.t, bytes_sent=prep.combine_bytes,
                    residual_norm=prep.residual_norm)
            self.control.round_executed(prep.t, prep.exec_s, prep.shares,
                                        prep.n_steps_real,
                                        worker_times=prep.worker_times)

    def _finish(self, prep: _PreparedRound, metrics, t0: float) -> RoundResult:
        """Consumer tail: result bookkeeping."""
        t = prep.t
        loss = float(metrics.loss)
        stats = padding_stats(prep.arrays)
        plans = ([prep.cache_plan] if prep.cache_plan is not None else
                 [p[5] for p in prep.worker_programs or () if p[5] is not None])
        hit = sum(c.hit_steps for c in plans)
        total = hit + sum(c.miss_steps for c in plans)
        result = RoundResult(
            round_idx=t, loss=loss, n_clients=len(prep.clients),
            makespan=prep.makespan, idle_time=prep.idle_time,
            useful_fraction=stats["useful_fraction"],
            wall_time=time.perf_counter() - t0,
            placement=self.placement.name, s_steps=prep.arrays.n_steps,
            pack_time=prep.pack_s,
            overlap_fraction=(prep.overlap_s / prep.pack_s
                              if prep.pack_s > 0 else 0.0),
            recompiles=self._compiles_total,
            cache_hit_rate=hit / total if total else 0.0,
            cache_bytes_saved=sum(c.bytes_saved for c in plans),
            exec_time=prep.exec_s, padded_steps=prep.padded_steps,
            slo_p50=prep.slo_p50, slo_p99=prep.slo_p99,
            combine_bytes=prep.combine_bytes,
            residual_norm=prep.residual_norm,
            barrier_stall_s=prep.stall_s, drift_fallback=prep.fallback,
            affinity_swaps=prep.affinity_swaps,
            stale_fraction=prep.stale_fraction, online_pool=prep.online_pool)
        crit = critique_round(
            round_idx=t, pack_s=prep.pack_s, overlap_s=prep.overlap_s,
            exec_s=prep.exec_s, combine_s=prep.combine_s,
            barrier_stall_s=prep.stall_s,
            makespan=prep.makespan, idle_time=prep.idle_time,
            n_workers=len(prep.workers),
            worker_meas=([(w[0], w[4]) for w in prep.worker_times]
                         if prep.worker_times else None))
        result.idle_fraction = crit.idle_fraction
        result.critical_path = crit.critical_path
        self.history.append(result)
        self.round_idx = t + 1
        self._sampler_ckpt_state = prep.sampler_st
        self._telemetry_ckpt_state = prep.telemetry_st
        self._control_ckpt_state = prep.control_st
        if self._tracer.enabled:
            self._tracer.counter("cache_hit_rate", result.cache_hit_rate)
            self._tracer.counter("online_pool", prep.online_pool)
            self._tracer.counter("combine_bytes", float(prep.combine_bytes))
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
        if self.obs is not None and self.obs.flight is not None:
            self.obs.flight.on_round(t, {
                "loss": loss, "n_clients": len(prep.clients),
                "makespan": prep.makespan, "pack_s": prep.pack_s,
                "exec_s": prep.exec_s, "stall_s": prep.stall_s,
                "critique": crit.as_dict()})
        if self._round_observer is not None:
            # Harness hook (launch/multihost.py): this round's control rows
            # onto the sidecar channel, in round order.  Observation only.
            self._round_observer(prep, result)
        if (self.ckpt is not None
                and (t + 1) % self.cfg.rounds_per_checkpoint == 0):
            self.save_checkpoint()
        return result

    # -- the round -------------------------------------------------------------
    def run_round(self) -> RoundResult:
        """One fully synchronous round (also the ``pipeline_depth=0`` path)."""
        t0 = time.perf_counter()
        if self.control is not None:
            self.control.begin_run(self.round_idx)
        try:
            prep = self._prepare_round(self.round_idx)
            prep.exec_t0 = time.perf_counter()
            metrics = self._execute(prep)
            self._post_execute(prep, metrics)
        except BaseException as e:
            # A prep that died between cache.plan and cache.apply left LRU
            # entries whose pool rows were never written: a retry would
            # serve them as bogus hits.
            if self._device_cache is not None:
                self._device_cache.invalidate()
            if self.control is not None:
                self.control.abort()
            self._flight_dump(f"run_round abort: {e!r}")
            raise
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
        try:
            return self._run_pipelined_inner(n_rounds, log_every=log_every)
        except BaseException as e:
            # Preps may have planned cache insertions whose pool rows were
            # never written (plan runs producer-side, apply consumer-side).
            if self._device_cache is not None:
                self._device_cache.invalidate()
            if self.control is not None:
                # Wake a producer stalled at the refit barrier: the round
                # it waits for will never finish now.
                self.control.abort()
            self._flight_dump(f"pipeline abort: {e!r}")
            raise

    def _flight_dump(self, reason: str) -> None:
        """Flight-recorder dump on an engine abort (never raises: the
        recorder guards itself, and this must not mask the primary
        error)."""
        if self.obs is not None and self.obs.flight is not None:
            path = self.obs.flight.dump(reason)
            if path is not None:
                print(f"flight recorder: dumped {path} ({reason})")

    def _run_pipelined_inner(self, n_rounds: int, *, log_every: int = 0
                             ) -> list[RoundResult]:
        out: list[RoundResult] = []
        first = self.round_idx
        last = first + n_rounds - 1
        depth = self.cfg.pipeline_depth
        queue: deque = deque()
        aborted = False
        if self.control is not None:
            self.control.begin_run(first)

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
                    # (marks round t finished for the refit barrier before
                    # the queue wait below)
                except BaseException:
                    # Stop the producer too; the abort must land before the
                    # raise, or leaving the with-block would join a prep
                    # stalled at the refit barrier for its full timeout.
                    aborted = True
                    if self.control is not None:
                        self.control.abort()
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
        cache = (f" cache={r.cache_hit_rate:.0%}"
                 if (r.cache_hit_rate or r.cache_bytes_saved) else "")
        print(f"round {r.round_idx:5d} loss={r.loss:.4f} "
              f"clients={r.n_clients} S={r.s_steps} "
              f"useful={r.useful_fraction:.2%} idle={r.idle_time:.1f}s "
              f"pack={r.pack_time * 1e3:.0f}ms "
              f"exec={r.exec_time * 1e3:.0f}ms "
              f"overlap={r.overlap_fraction:.0%}" + cache)

    # -- fault tolerance -----------------------------------------------------
    def save_checkpoint(self) -> None:
        """Checkpoint the state after round ``round_idx - 1`` (the
        reference's ``save_checkpoint``)."""
        extra: dict = {"round": self.round_idx}
        # The per-round snapshots taken at prepare time: at depth >= 1 the
        # live RNGs are ahead by the in-flight preps, but these match
        # round_idx exactly, so a restore reproduces the workload stream.
        if self._sampler_ckpt_state is not None:
            extra["sampler"] = self._sampler_ckpt_state
        elif (st := sampler_state(self.sampler)) is not None:
            extra["sampler"] = st              # pre-first-round checkpoint
        if self._telemetry_ckpt_state is not None:
            extra["telemetry_rng"] = self._telemetry_ckpt_state
        elif hasattr(self.telemetry, "state_dict"):
            extra["telemetry_rng"] = self.telemetry.state_dict()
        if isinstance(self.placement, LearningBasedPlacement):
            # Only rows of rounds already BOOKED: the producer may have
            # recorded telemetry for in-flight rounds, which re-run (and
            # re-record) after a restore.  Snapshot the model dict and each
            # row list once — the producer may be appending to them.
            extra["telemetry"] = {
                t: [list(r) for r in list(m._xs) if r[0] < self.round_idx]
                for t, m in list(self.placement.models.items())}
        aux_tree = {}
        if self._compress is not None:
            # Committed for rounds <= round_idx - 1 by now: the sidecar
            # matches round_idx exactly.
            extra["combine_compress"] = self._compress.state_meta()
            comp_aux = self._compress.state_aux()
            if comp_aux is not None:
                aux_tree["compress"] = comp_aux
        if self._control_ckpt_state is not None:
            # The control loop (drift EWMAs, slot trajectory, pending
            # measured rows), snapshotted at prepare time so it matches
            # round_idx at any depth; JSON in one uint8 leaf, as the
            # reference writes it.
            payload = np.frombuffer(
                json.dumps(self._control_ckpt_state).encode("utf-8"),
                dtype=np.uint8).copy()
            extra["control"] = {"nbytes": int(payload.size)}
            aux_tree["control"] = payload
        if self._host_map is not None:
            # The combine-tree family this trajectory was produced under.
            extra["host_layout"] = {"hosts": self._host_map.n_hosts,
                                    "shards": self._host_map.n_shards}
        if aux_tree:
            extra["aux_layout"] = "v2"
        self.ckpt.save(self.round_idx, self.params, extra=extra,
                       aux=aux_tree or None)

    def _restore_aux_entry(self, rnd: int, extra: dict, key: str, like):
        """Load one owner's subtree from the checkpoint aux sidecar.  v2
        sidecars nest per owner; pre-v2 ones hold the compress tree at the
        top level (and had no other owners)."""
        if extra.get("aux_layout") == "v2":
            out = self.ckpt.restore_aux({key: like}, round_idx=rnd)
            return None if out is None else out[key]
        if key != "compress":
            return None
        return self.ckpt.restore_aux(like, round_idx=rnd)

    def restore_latest(self) -> bool:
        """Resume from the newest checkpoint; False when there is none.

        The control plane resumes where round ``rnd``'s prep left it when
        the checkpoint carries its snapshot, and re-warms (``reset``)
        otherwise; an engine without a control plane ignores the
        snapshot, as the reference's does."""
        if self.ckpt is None or self.ckpt.latest_round() is None:
            return False
        params, rnd, extra = self.ckpt.restore(self.params)
        self.params = params
        self.round_idx = rnd
        if self._device_cache is not None:
            # The cache is not checkpointed; entries planned for rounds past
            # the restore point must not survive as hits.
            self._device_cache.invalidate()
        if self.control is not None:
            self._restore_control(rnd, extra)
        if extra.get("sampler"):
            try:
                self.sampler = restore_sampler(extra["sampler"])
            except (KeyError, ValueError) as e:
                _warn(
                    f"checkpoint sampler state unusable ({e!r}); resuming "
                    "with the configured sampler — the workload stream will "
                    "NOT match the original run")
        if extra.get("telemetry_rng") and hasattr(self.telemetry,
                                                  "load_state_dict"):
            try:
                self.telemetry.load_state_dict(extra["telemetry_rng"])
            except (KeyError, ValueError, TypeError) as e:
                _warn(
                    f"checkpoint telemetry RNG state unusable ({e!r}); "
                    "resuming with a fresh stream — synthetic times will "
                    "NOT match the uninterrupted run")
        self._restore_compress(rnd, extra)
        if (isinstance(self.placement, LearningBasedPlacement)
                and "telemetry" in extra):
            for tname, rows in extra["telemetry"].items():
                m = self.placement._model(tname)
                m._xs = [tuple(r) for r in rows]
                m._fit_sig = (-1, -1)      # direct _xs swap: force a refit
                m._recent_sig = (-1, -1, -1)
            self.placement.refit(self.round_idx)
        return True

    def _restore_control(self, rnd: int, extra: dict) -> None:
        """The control-plane snapshot from the aux sidecar, with the
        reference's fallbacks and warnings."""
        meta = extra.get("control")
        if meta:
            try:
                arr = self._restore_aux_entry(
                    rnd, extra, "control",
                    np.zeros(int(meta["nbytes"]), dtype=np.uint8))
                if arr is not None:
                    state = json.loads(
                        np.asarray(arr, dtype=np.uint8).tobytes())
                    self.control.load_state(state, rnd)
                    # A save before the next round finishes must keep it.
                    self._control_ckpt_state = state
                    return
                _warn("checkpoint lists controller state but the .aux.npz "
                      "sidecar is missing; resuming with a re-warmed "
                      "control loop")
            except (KeyError, ValueError, TypeError) as e:
                _warn(f"checkpoint controller state unusable ({e!r}); "
                      "resuming with a re-warmed control loop")
        self.control.reset(rnd)

    def _restore_compress(self, rnd: int, extra: dict) -> None:
        """The host-layout guard and the error-feedback residuals, with the
        reference's warnings: hosts = 0 (the legacy fold) and hosts >= 1
        (the canonical pairwise tree) are different combine arithmetic, so
        a checkpoint of one family resumes the other with zero residuals;
        so does a checkpoint of another compressor."""
        try:
            ckpt_hosts = int((extra.get("host_layout") or {}).get("hosts", 0))
        except (AttributeError, TypeError, ValueError):
            ckpt_hosts = 0     # malformed sidecar field: treat as legacy
        cfg_hosts = self._host_map.n_hosts if self._host_map is not None else 0
        mismatch = (ckpt_hosts >= 1) != (cfg_hosts >= 1)
        if mismatch:
            _warn(
                f"checkpoint host layout (hosts={ckpt_hosts}) does not match "
                f"the configured engine (hosts={cfg_hosts}); the combine "
                "arithmetic families differ, so the resumed trajectory will "
                "NOT match the uninterrupted run"
                + ("; resuming with zero error-feedback residuals"
                   if self._compress is not None else ""))
        if self._compress is None:
            return
        self._compress.reset()
        meta = extra.get("combine_compress")
        if not meta or not meta.get("shards") or mismatch:
            return
        if (meta.get("mode") != self.cfg.combine_compress
                or meta.get("frac") != self.cfg.combine_topk_frac):
            _warn(
                f"checkpoint combine_compress state ({meta.get('mode')!r}, "
                f"frac={meta.get('frac')}) does not match the configured "
                "compressor; resuming with zero residuals — the resumed run "
                "will NOT match the uninterrupted one")
            return
        try:
            aux = self._restore_aux_entry(
                rnd, extra, "compress",
                self._compress.aux_like(meta["shards"]))
        except (KeyError, ValueError) as e:
            _warn(
                f"checkpoint residual state unusable ({e!r}); resuming with "
                "zero residuals — the resumed run will NOT match the "
                "uninterrupted one")
            return
        if aux is None:
            _warn(
                "checkpoint lists compressed-combine residuals but the "
                ".aux.npz sidecar is missing; resuming with zero residuals")
            return
        self._compress.load_state(aux)
