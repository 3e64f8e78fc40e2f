"""End-to-end federated training entry point of the port — the
counterpart of ``repro/launch/train.py`` for the paper's four tasks (IC,
SR, TG, MLM) and every LM arch (dense, ssm, MoE, hybrid, audio
encoder-decoder and VLM families).

Composes dataset → cohort sampler → placement → worker pool → round step
(partial aggregation through the K1 kernel, or the gather path for
FedMedian) → synthetic telemetry → time-model refit → checkpoints, on the
CUDA card::

    PYTHONPATH=src python -m repro_torch.launch.train --task sr --rounds 20
    PYTHONPATH=src python -m repro_torch.launch.train --task mlm --rounds 5
    PYTHONPATH=src python -m repro_torch.launch.train --task sr \
        --strategy fedmedian --rounds 10
    PYTHONPATH=src python -m repro_torch.launch.train --task ic --rounds 50 \
        --ckpt-dir /tmp/pollen_ic
    PYTHONPATH=src python -m repro_torch.launch.train --task ic --rounds 10 \
        --ckpt-dir /tmp/pollen_ic --resume
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --preset fl100m --rounds 3
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite-moe-3b-a800m --preset fl100m --rounds 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-base \
        --preset fl100m --rounds 2

and the mesh path — one program per worker, the shard-local tree combine,
int8 shard uploads folded by the K2 kernel::

    PYTHONPATH=src python -m repro_torch.launch.train --task sr --workers 4 \
        --mesh-workers 2 --combine-mode tree --combine-compress int8

the closed loop — placement learned from the card's measured round times
through the refit barrier, drift fallback, slot hill-climbing — the
open-world population, and the trace export and flight recorder::

    PYTHONPATH=src python -m repro_torch.launch.train --task sr \
        --telemetry measured --barrier-policy stall --pipeline-depth 2
    PYTHONPATH=src python -m repro_torch.launch.train --task sr \
        --drift-threshold 0.5 --adapt-interval 2
    PYTHONPATH=src python -m repro_torch.launch.train --task sr \
        --sampler online --population 1000000 --cohort 64 \
        --population-outage 4:8
    PYTHONPATH=src python -m repro_torch.launch.train --task sr \
        --trace-out trace.json --flight-rounds 8

and the device batch cache — hot clients' batch rows kept in device memory,
per shard on the mesh path, with cache-aware placement::

    PYTHONPATH=src python -m repro_torch.launch.train --task sr \
        --sampler zipf --device-cache-batches 512
    PYTHONPATH=src python -m repro_torch.launch.train --task sr \
        --workers 4 --mesh-workers 2 --sampler zipf \
        --device-cache-batches 256 --cache-affinity

Each task trains with the reference's client optimizer: ``adam(4e-5)``
for MLM, ``sgd(0.8, momentum=0.9, weight_decay=5e-4)`` for TG and
``sgd(0.05, ...)`` for IC and SR.  A checkpoint is written every
``rounds_per_checkpoint`` (25) rounds.

The flags are the reference's.  The process-per-host harness is
``python -m repro_torch.launch.multihost``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
from collections import Counter
from dataclasses import replace

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import ArchConfig, get_arch
from repro_torch.core import (EngineConfig, FederatedEngine,
                              SyntheticTelemetry, UniformSampler, ZipfSampler,
                              make_placement)
from repro_torch.core.sampling import PowerOfChoiceSampler
from repro_torch.data import make_federated_dataset
from repro_torch.data.federated import TASK_DISTRIBUTIONS
from repro_torch.distributed import FailureEvent, WorkerPool
from repro_torch.fl.strategy import strategy_from_name
from repro_torch.kernels import ops as kops
from repro_torch.models import lm, make_lane_loss_fn
from repro_torch.models.papertasks import make_task_model
from repro_torch.obs import make_observability, write_trace
from repro_torch.optim import adam, sgd

__all__ = ["build_engine", "lm_config", "main", "set_deterministic",
           "PRESETS"]

TASKS = ("ic", "sr", "tg", "mlm")

# LM presets, the reference's: "smoke" for tests and examples (the reduced
# config itself); "fl100m" the ~100 M-param end-to-end config.
PRESETS = {
    "smoke": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=512, seq_len=32,
                  batch_size=4),
    "fl100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                   head_dim=64, d_ff=2048, vocab_size=32_000, seq_len=256,
                   batch_size=8),
}


def set_deterministic() -> None:
    """Make the card's results a function of the inputs alone: fixed cuBLAS
    workspaces (set before the first GEMM), deterministic algorithms, full
    f32 GEMMs and convolutions.  The bit-identity of losses across
    pipeline depths rests on it."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    # Deterministic mode also NaN-fills every torch.empty, one extra pass
    # per allocation; the port reads no memory it has not written.
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _FrontendDataset:
    """A token dataset with the modality-stub arrays an arch needs beside
    ``tokens``, as the reference's ``_FrontendDataset``: ``patch_embed``
    ``[N, b, frontend_len, frontend_dim]`` (patch frontend) or ``frames``
    ``[N, b, frontend_len, d_model]`` (audio), f32 standard normal.  The
    content of (client, batch) comes from a numpy generator seeded with
    ``(7, cid * 131 + batch_idx)`` where the reference folds that number
    into ``jax.random.key(7)``: other values, the same distribution
    (``data/federated.py``)."""

    def __init__(self, base, cfg: ArchConfig):
        self.base = base
        self.cfg = cfg

    def __getattr__(self, name):
        return getattr(self.base, name)

    def client_batch(self, cid, batch_idx, *, batch_size=None, seq_len=None):
        out = self.gather_batches(np.asarray([cid]), np.asarray([batch_idx]),
                                  batch_size=batch_size, seq_len=seq_len)
        return {k: v[0] for k, v in out.items()}

    def gather_batches(self, cids, batch_idxs, *, batch_size=None,
                       seq_len=None):
        """The base dataset's tokens plus the stub arrays, in bulk."""
        b = self.base.gather_batches(cids, batch_idxs, batch_size=batch_size,
                                     seq_len=seq_len)
        cfg = self.cfg
        if cfg.frontend == "patch":
            name, width = "patch_embed", cfg.resolved_frontend_dim
        else:
            name, width = "frames", cfg.d_model
        if b["tokens"].shape[0] == 0:
            bs = batch_size or self.base.spec.batch_size
            b[name] = np.zeros((0, bs, cfg.frontend_len, width), np.float32)
            return b
        shape = (b["tokens"].shape[1], cfg.frontend_len, width)
        folds = (np.asarray(cids, np.int64) * 131
                 + np.asarray(batch_idxs, np.int64))
        b[name] = np.stack([np.random.default_rng([7, int(f)])
                            .standard_normal(shape, dtype=np.float32)
                            for f in folds])
        return b


def _parse_intervention(kind: str, spec: str):
    """``START:END[:SCALE][:REGION]`` -> Intervention (outage scale is 0)."""
    from repro_torch.population import Intervention

    parts = spec.split(":")
    if len(parts) < 2:
        raise ValueError(f"--population-{kind} needs START:END[:SCALE]"
                         f"[:REGION], got {spec!r}")
    start, end = int(parts[0]), int(parts[1])
    scale = 0.0 if kind == "outage" else 1.5
    region = None
    rest = parts[2:]
    if rest:
        try:
            scale = float(rest[0])
            rest = rest[1:]
        except ValueError:
            pass
    if rest:
        region = rest[0]
    return Intervention(kind, start, end, scale, region=region)


def lm_config(arch: str, preset: str = "smoke"
              ) -> tuple[ArchConfig, int, int]:
    """``(cfg, seq_len, batch_size)`` that the reference's ``build_engine``
    trains ``arch`` at under ``preset``: the arch's ``reduced()`` config
    (f32), then the preset's widths unless ``smoke`` — an MoE arch's
    experts as wide as the preset's ``d_ff`` — and a learned-position
    table at least ``seq_len`` long."""
    p = dict(PRESETS[preset])
    seq_len, batch_size = p.pop("seq_len"), p.pop("batch_size")
    cfg = get_arch(arch).reduced()
    if preset != "smoke":          # smoke == reduced()
        if cfg.moe:
            p.setdefault("moe_d_ff", p.get("d_ff", 128))
        cfg = replace(cfg, **p)
    if cfg.learned_pos:
        cfg = replace(cfg, max_position=max(cfg.max_position, seq_len))
    return cfg, seq_len, batch_size


def build_engine(*, task: str | None = None, arch: str | None = None,
                 preset: str = "smoke", lm_cfg: ArchConfig | None = None,
                 placement: str = "lb", cohort: int = 8,
                 population: int | None = None, workers: int = 2,
                 concurrency: int = 2, strategy: str = "fedavg",
                 steps_cap: int = 8, seed: int = 1337,
                 ckpt_dir: str | None = None, rounds_per_checkpoint: int = 25,
                 deadline_rho: float = 0.0,
                 pipeline_depth: int = 1, sampler: str = "uniform",
                 zipf_exponent: float = 1.2,
                 population_period: float = 48.0,
                 population_surge: str | None = None,
                 population_outage: str | None = None,
                 grad_clip: float | None = None,
                 mesh_workers: int = 0, bucket_mode: str = "round",
                 combine_mode: str = "flat", combine_compress: str = "none",
                 topk_frac: float = 0.05, hosts: int = 0,
                 obs=None, device="cuda", **engine_options) -> FederatedEngine:
    """Compose a runnable engine for a paper task or an LM arch preset, on
    ``device``.

    ``arch`` + ``preset`` train the arch at :func:`lm_config`'s config on
    the ``"lm"`` token dataset (wrapped in :class:`_FrontendDataset` for an
    arch with a frontend) with ``sgd(0.05, momentum=0.9)``, as the
    reference does; ``lm_cfg`` trains that config instead (any widths,
    the published ones included) at the preset's ``seq_len`` and
    ``batch_size``.  The weights come from ``lm.init_params(seed, cfg)``.
    ``mesh_workers`` .. ``hosts`` select the mesh path and its combine, as
    in the reference; ``strategy="fedmedian"`` the gather path; with
    ``ckpt_dir`` the engine saves a checkpoint there every
    ``rounds_per_checkpoint`` rounds (``restore_latest`` resumes from it).
    ``sampler="online"`` draws cohorts from the open-world population:
    ``population`` clients registered in a hash-derived store (O(1) memory
    in the population) over a base dataset of at most 4,096 clients,
    arriving by the diurnal regional traces rescaled to
    ``population_period`` rounds, with the ``population_surge`` and
    ``population_outage`` windows (``START:END[:SCALE][:REGION]``).
    ``engine_options`` are further :class:`EngineConfig` fields — the
    control plane's (``telemetry_mode``, ``barrier_policy``,
    ``drift_threshold``, ``adapt_interval``, ``adapt_granularity``, ...)
    and the device cache's (``device_cache_batches``,
    ``device_cache_bytes``, ``cache_affinity``).  Refuses a
    config whose layers do not make whole periods, and a CUDA ``device``
    without a card, before any work.
    """
    strat = strategy_from_name(strategy)
    # The open-world sampler streams from a hash-derived registry: the base
    # dataset (content and class tables) stays small however many clients
    # ``population`` registers.
    base_clients = population
    if sampler == "online" and population:
        base_clients = min(population, 4096)
    if lm_cfg is None and arch is not None:
        lm_cfg = lm_config(arch, preset)[0]
    if lm_cfg is not None:
        lm.layer_plan(lm_cfg)
        seq_len = PRESETS[preset]["seq_len"]
        batch_size = PRESETS[preset]["batch_size"]
    else:
        task = task or "sr"
        seq_len, batch_size = None, TASK_DISTRIBUTIONS[task].batch_size
    config = EngineConfig(steps_cap=steps_cap, lanes_per_worker=concurrency,
                          grad_clip=grad_clip, deadline_rho=deadline_rho,
                          pipeline_depth=pipeline_depth,
                          batch_size=batch_size, seq_len=seq_len,
                          mesh_workers=mesh_workers, bucket_mode=bucket_mode,
                          combine_mode=combine_mode,
                          combine_compress=combine_compress,
                          combine_topk_frac=topk_frac, hosts=hosts,
                          rounds_per_checkpoint=rounds_per_checkpoint,
                          **engine_options)
    device = resolve_device(device)
    if lm_cfg is not None:
        ds = make_federated_dataset(
            "lm", seed=seed, vocab_size=lm_cfg.vocab_size, seq_len=seq_len,
            batch_size=batch_size, n_clients=base_clients or 4096)
        if lm_cfg.frontend:
            ds = _FrontendDataset(ds, lm_cfg)
        params = lm.init_params(seed, lm_cfg, device=device)
        loss_fn = make_lane_loss_fn(lm_cfg)
        optimizer = sgd(0.05, momentum=0.9)
    else:
        ds = make_federated_dataset(
            task, seed=seed,
            **({"n_clients": base_clients} if base_clients else {}))
        params, loss_fn = make_task_model(task, seed, device=device)
        optimizer = (adam(4e-5) if task == "mlm" else
                     sgd(0.8 if task == "tg" else 0.05, momentum=0.9,
                         weight_decay=5e-4))
    if sampler == "online":
        from repro_torch.population import (ArrivalIndex,
                                            ClientMetadataStore,
                                            OnlinePoolSampler,
                                            PopulationDataset)
        store = ClientMetadataStore(population or ds.n_clients, seed=seed,
                                    batch_size=ds.spec.batch_size)
        interventions = []
        if population_surge:
            interventions.append(
                _parse_intervention("surge", population_surge))
        if population_outage:
            interventions.append(
                _parse_intervention("outage", population_outage))
        index = ArrivalIndex(store, period=population_period,
                             interventions=tuple(interventions))
        ds = PopulationDataset(ds, store)
        sampler_obj = OnlinePoolSampler(index, cohort, seed=seed)
    elif sampler == "zipf":
        sampler_obj = ZipfSampler(ds.n_clients, cohort, a=zipf_exponent,
                                  seed=seed)
    elif sampler == "poc":
        sampler_obj = PowerOfChoiceSampler(ds.n_clients, cohort, seed=seed)
    else:
        sampler_obj = UniformSampler(ds.n_clients, cohort, seed=seed)
    return FederatedEngine(
        dataset=ds, loss_fn=loss_fn, init_params=params,
        optimizer=optimizer, placement=make_placement(placement),
        sampler=sampler_obj,
        pool=WorkerPool.homogeneous(workers, type_name="a40",
                                    concurrency=concurrency),
        telemetry=SyntheticTelemetry(seed=seed), strategy=strat,
        config=config,
        checkpoint_store=CheckpointStore(ckpt_dir) if ckpt_dir else None,
        obs=obs, device=device)


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Pollen FL simulation on the CUDA card (port).  Flags "
                    "as in repro.launch.train.")
    ap.add_argument("--task", choices=TASKS, default=None)
    ap.add_argument("--arch", default=None,
                    help="an LM arch of any family (dense, ssm, MoE, "
                         "hybrid, audio encoder-decoder, VLM)")
    ap.add_argument("--preset", choices=list(PRESETS), default="smoke",
                    help="LM preset, used only with --arch")
    ap.add_argument("--placement", default="lb", choices=["rr", "bb", "lb"])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--cohort", type=int, default=8)
    ap.add_argument("--population", type=int, default=None)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--concurrency", type=int, default=2)
    ap.add_argument("--strategy", default="fedavg",
                    choices=["fedavg", "fedmedian"])
    ap.add_argument("--steps-cap", type=int, default=8)
    ap.add_argument("--grad-clip", type=float, default=None)
    ap.add_argument("--pipeline-depth", type=int, default=1)
    ap.add_argument("--device-cache-batches", type=int, default=0)
    ap.add_argument("--device-cache-mb", type=float, default=0.0)
    ap.add_argument("--sampler", default="uniform",
                    choices=["uniform", "zipf", "online", "poc"])
    ap.add_argument("--zipf-exponent", type=float, default=1.2)
    ap.add_argument("--population-period", type=float, default=48.0)
    ap.add_argument("--population-surge", default=None)
    ap.add_argument("--population-outage", default=None)
    ap.add_argument("--telemetry", default="synthetic",
                    choices=["synthetic", "measured"])
    ap.add_argument("--barrier-policy", default="reuse",
                    choices=["reuse", "stall"])
    ap.add_argument("--drift-threshold", type=float, default=0.0)
    ap.add_argument("--adapt-interval", type=int, default=0)
    ap.add_argument("--adapt-granularity", default="type",
                    choices=["type", "worker"])
    ap.add_argument("--mesh-workers", type=int, default=0)
    ap.add_argument("--cache-affinity", action="store_true")
    ap.add_argument("--bucket-mode", default="round",
                    choices=["round", "worker"])
    ap.add_argument("--combine-mode", default="flat", choices=["flat", "tree"])
    ap.add_argument("--combine-compress", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--topk-frac", type=float, default=0.05)
    ap.add_argument("--hosts", type=int, default=0)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--trace-rounds", type=int, default=64)
    ap.add_argument("--flight-rounds", type=int, default=0)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--deadline-rho", type=float, default=0.0)
    ap.add_argument("--fail-worker", default=None,
                    help="WID:ROUND — inject a worker failure")
    ap.add_argument("--join-worker", default=None, help="WID:ROUND")
    ap.add_argument("--metrics-out", default=None)
    return ap


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    obs = None
    if args.trace_out or args.flight_rounds > 0:
        obs = make_observability(trace_rounds=args.trace_rounds,
                                 flight_rounds=args.flight_rounds)
    set_deterministic()
    engine = build_engine(
        task=args.task, arch=args.arch, preset=args.preset,
        placement=args.placement,
        cohort=args.cohort, population=args.population,
        workers=args.workers, concurrency=args.concurrency,
        strategy=args.strategy, steps_cap=args.steps_cap, seed=args.seed,
        ckpt_dir=args.ckpt_dir, grad_clip=args.grad_clip,
        deadline_rho=args.deadline_rho, pipeline_depth=args.pipeline_depth,
        sampler=args.sampler, zipf_exponent=args.zipf_exponent,
        population_period=args.population_period,
        population_surge=args.population_surge,
        population_outage=args.population_outage,
        device_cache_batches=args.device_cache_batches,
        device_cache_bytes=int(args.device_cache_mb * 2**20),
        telemetry_mode=args.telemetry, barrier_policy=args.barrier_policy,
        drift_threshold=args.drift_threshold,
        adapt_interval=args.adapt_interval,
        adapt_granularity=args.adapt_granularity,
        mesh_workers=args.mesh_workers, cache_affinity=args.cache_affinity,
        bucket_mode=args.bucket_mode, combine_mode=args.combine_mode,
        combine_compress=args.combine_compress, topk_frac=args.topk_frac,
        hosts=args.hosts, obs=obs)
    if obs is not None and obs.flight is not None:
        def _on_sigterm(signum, frame):  # last-gasp state dump
            obs.flight.dump("SIGTERM")
            raise SystemExit(128 + signum)
        signal.signal(signal.SIGTERM, _on_sigterm)
    if args.fail_worker:
        wid, rnd = (int(x) for x in args.fail_worker.split(":"))
        engine.pool.schedule(FailureEvent(round_idx=rnd, kind="fail",
                                          wid=wid))
    if args.join_worker:
        wid, rnd = (int(x) for x in args.join_worker.split(":"))
        engine.pool.schedule(FailureEvent(round_idx=rnd, kind="join",
                                          wid=wid, type_name="a40"))
    if args.resume and engine.restore_latest():
        print(f"resumed from round {engine.round_idx}")
    kops.reset_launch_counts()
    results = engine.run(args.rounds, log_every=1)
    summary = {
        "device": str(engine.device),
        "rounds": len(results),
        "final_loss": results[-1].loss if results else None,
        "total_idle_s": sum(r.idle_time for r in results),
        "mean_useful_fraction": float(np.mean(
            [r.useful_fraction for r in results])) if results else None,
        "placement": args.placement,
        "pipeline_depth": args.pipeline_depth,
        "mean_overlap_fraction": float(np.mean(
            [r.overlap_fraction for r in results])) if results else None,
        "mean_exec_s": float(np.mean(
            [r.exec_time for r in results])) if results else None,
        "slo_p50_s": float(np.mean(
            [r.slo_p50 for r in results])) if results else None,
        "slo_p99_s": float(np.mean(
            [r.slo_p99 for r in results])) if results else None,
        "mean_idle_fraction": float(np.mean(
            [r.idle_fraction for r in results])) if results else None,
        "critical_path": dict(Counter(
            r.critical_path for r in results if r.critical_path)),
        "kernel_launches": kops.launch_counts(),
    }
    if obs is not None:
        summary["tracer"] = obs.tracer.stats()
    if args.sampler == "online":
        summary["population"] = {
            "registered": int(engine.sampler.population),
            "mean_online_pool": float(np.mean(
                [r.online_pool for r in results])) if results else None,
            "mean_stale_fraction": float(np.mean(
                [r.stale_fraction for r in results])) if results else None,
        }
    if args.device_cache_batches or args.device_cache_mb:
        summary["cache_hit_rate"] = float(np.mean(
            [r.cache_hit_rate for r in results])) if results else None
        summary["cache_bytes_saved"] = int(sum(
            r.cache_bytes_saved for r in results))
    if args.mesh_workers >= 2:
        summary["mesh_workers"] = args.mesh_workers
        summary["affinity_swaps"] = int(sum(
            r.affinity_swaps for r in results))
        summary["bucket_mode"] = args.bucket_mode
        summary["combine_mode"] = args.combine_mode
        summary["padded_steps"] = int(sum(r.padded_steps for r in results))
        summary["combine_bytes_per_round"] = int(np.mean(
            [r.combine_bytes for r in results])) if results else 0
        if args.hosts >= 1:
            summary["hosts"] = args.hosts
        if args.combine_compress != "none":
            summary["combine_compress"] = args.combine_compress
            summary["final_residual_norm"] = (
                results[-1].residual_norm if results else 0.0)
        if engine.cache_stats.get("per_shard"):
            summary["cache_per_shard"] = engine.cache_stats["per_shard"]
    if engine.control is not None:
        summary["control"] = engine.control_stats
        summary["barrier_stall_s"] = float(sum(
            r.barrier_stall_s for r in results))
        summary["fallback_rounds"] = int(sum(
            r.drift_fallback for r in results))
    if args.trace_out:
        recs = obs.tracer.snapshot()
        write_trace(args.trace_out, recs)
        print(f"trace: wrote {len(recs)} records to {args.trace_out}")
    print(json.dumps(summary, indent=1))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"summary": summary,
                       "history": [vars(r) for r in results]}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
