"""Controller validation against the discrete-event cluster simulator.

The control plane must be exercised against worker churn, stragglers, and
workload skew long before any real cluster exists.  This module drives a
:class:`~repro_torch.control.controller.ControlPlane` through the exact call
sequence the engine uses (``advance_to`` → ``on_pool_events`` →
``pre_round`` → refit → assign → simulate → ``round_executed``), but the
"execution" is the simcluster Eq. 3 time family
(:func:`repro_torch.simcluster.engine.client_time`): per-client times are drawn
per GPU type with concurrency-dependent slowdown and heteroscedastic
noise, exactly the structure the paper measures — and, unlike wall-clock
runs, **deterministic given the seed**, which is what lets
``bench_control`` gate drift-detection latency and adaptation gain in CI.

Scenarios:

* ``"straggler"`` — the cluster slows down mid-run (time-scale jump, the
  canonical straggler storm): the drift detector must fire within a couple
  of rounds, placement falls back to Batches-Based, and — once the old
  telemetry has aged out of the retention window — the refit recovers and
  LB placement resumes.
* ``"fail"``   — a worker fails, another of the same type joins later:
  placement must keep its per-type model warm across both events (the
  join bootstraps from pooled same-type telemetry; no RR warm-up relapse).
* ``"skew"``   — the sampler's Zipf exponent shifts mid-run (a different
  client population turns hot): the x-conditional model extrapolates, so
  this must NOT trip the drift alarm (false-positive check).
* ``"adapt"``  — per-type client slots are seeded below the optimum; with
  an OS-scheduling thrash term making oversubscription costly, the hill
  climber must recover most of the throughput headroom.
* ``"surge"``  — open-world population: an arrival surge multiplies the
  diurnal online rate mid-run.  The online pool swells (more distinct
  clients per window) but per-client hardware behaviour is unchanged — a
  *population* shift, so the drift alarm must stay quiet (false-positive
  check) while the pool-size trajectory shows the surge.
* ``"outage"`` — a whole region goes dark for a window: the expected
  online pool drops by that region's share and recovers when the outage
  ends; the stale-client fraction stays bounded (the other regions cover
  the cohort) and, again, no hardware drift may be reported.

The surge/outage scenarios drive the SAME harness through an
:class:`~repro_torch.population.sampler.OnlinePoolSampler` instead of the Zipf
sampler — the user-facing catalog for all six storms lives in
docs/POPULATION.md.
"""

from __future__ import annotations

import numpy as np

from repro_torch.control.controller import ControllerConfig, ControlPlane
from repro_torch.core.placement import ClientInfo, LearningBasedPlacement
from repro_torch.core.sampling import ZipfSampler
from repro_torch.distributed.elastic import FailureEvent, WorkerPool
from repro_torch.simcluster.engine import client_time
from repro_torch.simcluster.profiles import TASKS

__all__ = ["run_scenario", "SCENARIOS"]


def _client_sizes(rng: np.random.Generator, population: int) -> np.ndarray:
    """Lognormal batch counts (the paper's Fig. 7 cloud of small clients)."""
    return np.maximum(1, rng.lognormal(mean=2.8, sigma=0.7, size=population)).astype(int)


def _default_pool() -> WorkerPool:
    # Two A40s and two 2080 Tis at the Table-3 "ic" concurrency levels.
    return WorkerPool.from_specs(
        [("a40", 1.0, 14), ("a40", 1.0, 14), ("2080ti", 0.38, 4), ("2080ti", 0.38, 4)]
    )


def _drive(
    *,
    rounds: int,
    seed: int,
    cohort: int,
    population: int,
    pool: WorkerPool,
    cfg: ControllerConfig,
    time_scale_fn=None,
    thrash: float = 0.0,
    sampler_a_fn=None,
    sampler=None,
    max_points: int | None = None,
    task_name: str = "ic",
) -> dict:
    """Run one controller-in-the-loop simulation; returns a summary dict.

    ``sampler`` injects any ``sample(round_idx)`` sampler (the population
    scenarios pass an OnlinePoolSampler); default is the Zipf workload.
    """
    rng = np.random.default_rng(seed)
    task = TASKS[task_name]
    sizes = _client_sizes(rng, population)
    placement = LearningBasedPlacement(max_points=max_points)
    ctl = ControlPlane(cfg, placement=placement, pool=pool)
    if sampler is None:
        sampler = ZipfSampler(population, cohort, a=1.6, seed=seed)
    by_wid = {}
    throughput, makespans, fallback_rounds = [], [], []
    slo_p99s, stale_fractions, online_pools = [], [], []
    ctl.begin_run(0)
    for t in range(rounds):
        fired = pool.advance_to(t)
        if fired:
            ctl.on_pool_events(t, fired)
        if sampler_a_fn is not None and isinstance(sampler, ZipfSampler):
            a = sampler_a_fn(t)
            if a != sampler.a:
                sampler = ZipfSampler(population, cohort, a=a, seed=seed + t)
        info = ctl.pre_round(t)
        placement.refit(t)
        workers = pool.snapshot()
        by_wid = {w.wid: w for w in workers}
        ids = sampler.sample(t)
        clients = [ClientInfo(cid=int(c), n_batches=int(sizes[int(c)])) for c in ids]
        place = ctl.fallback_placement if info.fallback else placement
        assignment = place.assign(clients, workers)
        scale = time_scale_fn(t) if time_scale_fn is not None else 1.0
        rows, finish = [], {}
        for wid, cs in assignment.per_worker.items():
            w = by_wid[wid]
            total = 0.0
            for c in cs:
                sec = client_time(
                    rng,
                    task,
                    w.type_name,
                    int(c.n_batches),
                    w.concurrency,
                    dataload_contention=task.dataload_cost,
                )
                sec = sec * scale + thrash * w.concurrency**2
                rows.append((w.type_name, c.n_batches, sec))
                total += sec
            finish[wid] = total / max(w.concurrency, 1)
        makespan = max(finish.values()) if finish else 0.0
        ctl.round_executed(t, makespan, None, len(clients), rows=rows)
        makespans.append(makespan)
        throughput.append(len(clients) / makespan if makespan > 0 else 0.0)
        secs = [r[2] for r in rows]
        slo_p99s.append(float(np.percentile(secs, 99.0)) if secs else 0.0)
        st = getattr(sampler, "last_stats", None)
        if st:
            stale_fractions.append(float(st.get("stale_fraction", 0.0)))
            online_pools.append(float(st.get("online_pool", 0.0)))
        if info.fallback:
            fallback_rounds.append(t)
    return {
        "rounds": rounds,
        "throughput": throughput,
        "makespans": makespans,
        "slo_p99": slo_p99s,
        "stale_fraction": stale_fractions,
        "online_pool": online_pools,
        "fallback_rounds": fallback_rounds,
        "controller": ctl.stats(),
        "audit_violations": len(ctl.audit()),
        "drift_events": list(ctl.drift.events) if ctl.drift is not None else [],
        "slots_trajectory": (
            list(ctl.autoconc.trajectory) if ctl.autoconc is not None else []
        ),
        "placement_ready": placement.ready_for(pool.snapshot()),
        "_ctl": ctl,
    }


def _base_cfg(**overrides) -> ControllerConfig:
    # Threshold calibration (seeded, deterministic): the heteroscedastic
    # noise floor drives the residual EWMA to ~0.49 at worst during a pure
    # workload-skew shift, while a 2.5x straggler storm drives it past 1.3 —
    # 0.6 separates the two with margin on both sides; recovery at 0.36
    # clears the ~0.28 steady-state noise EWMA.
    kw = dict(
        telemetry_mode="measured",
        barrier_policy="stall",
        drift_threshold=0.60,
        drift_window=8,
        drift_min_points=8,
        drift_recover_fraction=0.6,
    )
    kw.update(overrides)
    return ControllerConfig(**kw)


def _scenario_straggler(*, rounds=48, seed=7, cohort=16, population=512) -> dict:
    """Time-scale jump at ``shift``: detect fast, fall back, recover once the
    pre-shift telemetry ages out of the retention window."""
    shift = 12
    out = _drive(
        rounds=rounds,
        seed=seed,
        cohort=cohort,
        population=population,
        pool=_default_pool(),
        cfg=_base_cfg(),
        time_scale_fn=lambda t: 2.5 if t >= shift else 1.0,
        max_points=12 * cohort,  # old-scale rows age out -> recovery
    )
    drifts = [e for e in out["drift_events"] if e[2] == "drift" and e[0] >= shift]
    recovers = [e for e in out["drift_events"] if e[2] == "recover" and e[0] > shift]
    first = min((e[0] for e in drifts), default=None)
    return {
        "shift_round": shift,
        "detected": bool(drifts),
        "detect_round": first,
        "detect_delay": (first - shift) if first is not None else None,
        "fallback_rounds": len(out["fallback_rounds"]),
        "recovered": bool(recovers),
        "recover_round": min((e[0] for e in recovers), default=None),
        "audit_violations": out["audit_violations"],
    }


def _scenario_fail(*, rounds=24, seed=7, cohort=16, population=512) -> dict:
    """Worker fail + same-type join: the per-type model must stay warm (the
    joining worker bootstraps from pooled same-type telemetry)."""
    pool = _default_pool()
    pool.schedule(FailureEvent(round_idx=8, kind="fail", wid=0))
    pool.schedule(
        FailureEvent(round_idx=14, kind="join", wid=9, type_name="a40", concurrency=14)
    )
    out = _drive(
        rounds=rounds,
        seed=seed,
        cohort=cohort,
        population=population,
        pool=pool,
        cfg=_base_cfg(),
    )
    ctl = out["_ctl"]
    return {
        "pool_events_seen": sum(1 for (_, k, _) in ctl.log if k in ("fail", "join")),
        "final_workers": len(pool),
        "model_ready_after_join": out["placement_ready"],
        "fallback_rounds": len(out["fallback_rounds"]),
        "audit_violations": out["audit_violations"],
    }


def _scenario_skew(*, rounds=36, seed=7, cohort=16, population=512) -> dict:
    """Zipf-exponent shift (workload skew): the x-conditional model must NOT
    raise a false drift alarm."""
    out = _drive(
        rounds=rounds,
        seed=seed,
        cohort=cohort,
        population=population,
        pool=_default_pool(),
        cfg=_base_cfg(),
        sampler_a_fn=lambda t: 0.4 if t >= rounds // 2 else 1.6,
    )
    drifts = [e for e in out["drift_events"] if e[2] == "drift"]
    return {
        "false_drifts": len(drifts),
        "fallback_rounds": len(out["fallback_rounds"]),
        "audit_violations": out["audit_violations"],
    }


def _scenario_adapt(*, rounds=60, seed=7, cohort=32, population=512) -> dict:
    """Slots seeded far below the optimum; quadratic thrash makes blind
    oversubscription costly.  The hill climber must recover throughput."""
    pool = WorkerPool.from_specs([("a40", 1.0, 2), ("a40", 1.0, 2)])
    out = _drive(
        rounds=rounds,
        seed=seed,
        cohort=cohort,
        population=population,
        pool=pool,
        cfg=_base_cfg(
            drift_threshold=0.0,
            adapt_interval=3,
            adapt_min_slots=1,
            adapt_max_slots=14,  # the Table-3 VRAM bound for "ic" on an A40
        ),
        thrash=0.10,
    )
    thr = out["throughput"]
    k = max(1, rounds // 6)
    start, end = float(np.mean(thr[:k])), float(np.mean(thr[-k:]))
    slots = out["_ctl"].autoconc.stats()["slots"]
    return {
        "seed_slots": 2,
        "final_slots": slots,
        "updates": out["_ctl"].autoconc.updates,
        "throughput_start": start,
        "throughput_end": end,
        "gain_x": end / start if start > 0 else 0.0,
        "audit_violations": out["audit_violations"],
    }


def _population_sampler(population, cohort, seed, interventions=()):
    """OnlinePoolSampler over a fresh hash store (scenario-scale)."""
    from repro_torch.population import ArrivalIndex, ClientMetadataStore, OnlinePoolSampler

    store = ClientMetadataStore(population, seed=seed)
    index = ArrivalIndex(store, interventions=tuple(interventions))
    return OnlinePoolSampler(index, cohort, seed=seed), index


# Drift warm-up for the population scenarios: the open-world uniform draw
# shows the time model almost entirely NEW clients each round (no zipf
# recurrence), so early out-of-sample residuals are extrapolation noise and
# the EWMA — seeded from the first observation — needs ~90 points at
# window 8 to wash them out.  128 points (~2 rounds/worker-type of margin)
# keeps the alarm quiet on pure population shifts while a genuine 2.5x
# hardware storm still trips it within a round (calibrated, seeded).
_POPULATION_DRIFT_MIN_POINTS = 128


def _scenario_surge(*, rounds=36, seed=7, cohort=16, population=2048) -> dict:
    """Arrival surge at ``shift``: the online pool swells (a 1.5x global
    rate multiplier), but per-client hardware behaviour is unchanged — a
    pure POPULATION shift that must not trip the hardware drift alarm."""
    from repro_torch.population import Intervention

    shift = rounds // 2
    sampler, index = _population_sampler(
        population,
        cohort,
        seed,
        interventions=[Intervention("surge", shift, rounds, 1.5)],
    )
    out = _drive(
        rounds=rounds,
        seed=seed,
        cohort=cohort,
        population=population,
        pool=_default_pool(),
        cfg=_base_cfg(drift_min_points=_POPULATION_DRIFT_MIN_POINTS),
        sampler=sampler,
    )
    drifts = [e for e in out["drift_events"] if e[2] == "drift"]
    pools = out["online_pool"]
    pool_before = float(np.mean(pools[:shift]))
    pool_after = float(np.mean(pools[shift:]))
    return {
        "surge_round": shift,
        "pool_before": pool_before,
        "pool_after": pool_after,
        "pool_gain_x": pool_after / pool_before if pool_before else 0.0,
        "stale_peak": float(np.max(out["stale_fraction"])),
        "mean_slo_p99": float(np.mean(out["slo_p99"])),
        "probes_per_round": index.probes / rounds,
        "false_drifts": len(drifts),
        "fallback_rounds": len(out["fallback_rounds"]),
        "audit_violations": out["audit_violations"],
    }


def _scenario_outage(*, rounds=36, seed=7, cohort=16, population=2048) -> dict:
    """Regional outage: one region's rate crushed to zero over a window.
    The expected pool drops by that region's share and RECOVERS when the
    window ends; the surviving regions keep the cohort full (bounded stale
    fraction) and the drift alarm must stay quiet."""
    from repro_torch.population import Intervention

    start, end = rounds // 3, 2 * rounds // 3
    sampler, index = _population_sampler(
        population,
        cohort,
        seed,
        interventions=[Intervention("outage", start, end, 0.0, region="apac")],
    )
    out = _drive(
        rounds=rounds,
        seed=seed,
        cohort=cohort,
        population=population,
        pool=_default_pool(),
        cfg=_base_cfg(drift_min_points=_POPULATION_DRIFT_MIN_POINTS),
        sampler=sampler,
    )
    drifts = [e for e in out["drift_events"] if e[2] == "drift"]
    pools = out["online_pool"]
    pool_before = float(np.mean(pools[:start]))
    pool_during = float(np.mean(pools[start:end]))
    pool_after = float(np.mean(pools[end:]))
    return {
        "outage_window": [start, end],
        "pool_before": pool_before,
        "pool_during": pool_during,
        "pool_after": pool_after,
        "pool_drop_fraction": 1.0 - pool_during / pool_before if pool_before else 0.0,
        "recovered": pool_after > 0.9 * pool_before,
        "stale_peak": float(np.max(out["stale_fraction"])),
        "mean_slo_p99": float(np.mean(out["slo_p99"])),
        "false_drifts": len(drifts),
        "fallback_rounds": len(out["fallback_rounds"]),
        "audit_violations": out["audit_violations"],
    }


SCENARIOS = {
    "straggler": _scenario_straggler,
    "fail": _scenario_fail,
    "skew": _scenario_skew,
    "adapt": _scenario_adapt,
    "surge": _scenario_surge,
    "outage": _scenario_outage,
}


def run_scenario(name: str, **kw) -> dict:
    """Run one named scenario; returns its (JSON-serializable) summary."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; have {sorted(SCENARIOS)}")
    return SCENARIOS[name](**kw)
