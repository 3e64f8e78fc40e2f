"""The closed-loop control plane: one object the engine talks to.

:class:`ControlPlane` composes the three feedback mechanisms —

* :class:`~repro_torch.control.telemetry.MeasuredTelemetry` (wall-clock rounds,
  refit barrier),
* :class:`~repro_torch.control.drift.DriftDetector` (is the time model still
  predicting?),
* :class:`~repro_torch.control.autoconc.AdaptiveConcurrency` (how many client
  slots per worker?)

— behind four calls that slot into the engine's existing producer/consumer
split without breaking its ordering invariant:

========================  =======================  ==========================
call                      thread                   when
========================  =======================  ==========================
:meth:`pre_round`         producer, round order    top of ``_prepare_round``
:meth:`round_prepared`    producer, round order    end of ``_prepare_round``
:meth:`round_executed`    consumer                 right after the loss sync
:meth:`on_pool_events`    producer, round order    after ``pool.advance_to``
========================  =======================  ==========================

Every *consequential* mutation (placement-model rows, drift state, slot
counts on the worker pool) happens on the producer in strict round order —
the consumer only appends to the measured pending buffer and marks rounds
finished.  In synthetic mode the controller therefore preserves the
engine's bit-identity across pipeline depths even while actively steering
concurrency: its inputs (simulated makespans) and its decision points
(prepare-time, round order) are depth-independent.  In measured mode the
refit barrier replaces bit-identity with the paper's protocol guarantee:
no prep consumes a round that has not finished.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from repro_torch.control.autoconc import AdaptiveConcurrency
from repro_torch.control.drift import DriftDetector, relative_errors
from repro_torch.control.telemetry import MeasuredTelemetry, audit_violations
from repro_torch.core.placement import BatchesBasedPlacement, LearningBasedPlacement

__all__ = ["ControllerConfig", "ControlPlane", "PreRound"]


@dataclass(frozen=True)
class ControllerConfig:
    """Knobs for the control plane (mirrored by ``EngineConfig`` fields)."""

    telemetry_mode: str = "synthetic"  # "synthetic" | "measured"
    barrier_policy: str = "reuse"  # "reuse" | "stall"
    stall_timeout_s: float = 120.0
    drift_threshold: float = 0.0  # 0 disables drift detection
    drift_window: int = 16
    drift_recover_fraction: float = 0.5
    drift_min_points: int = 8
    adapt_interval: int = 0  # 0 disables adaptive concurrency
    adapt_min_slots: int = 1
    adapt_max_slots: int = 64
    adapt_min_gain: float = 0.0
    adapt_granularity: str = "type"  # "type" | "worker" (per-wid slots)

    def __post_init__(self):
        if self.telemetry_mode not in ("synthetic", "measured"):
            raise ValueError(
                f"telemetry_mode must be 'synthetic' or 'measured', "
                f"got {self.telemetry_mode!r}"
            )
        if self.barrier_policy not in ("reuse", "stall"):
            raise ValueError(
                f"barrier_policy must be 'reuse' or 'stall', "
                f"got {self.barrier_policy!r}"
            )
        if self.barrier_policy == "stall" and self.telemetry_mode != "measured":
            raise ValueError(
                "barrier_policy='stall' requires telemetry_mode='measured' "
                "(synthetic telemetry has no finish-time barrier to stall on)"
            )
        if self.drift_threshold < 0:
            raise ValueError(f"drift_threshold must be >= 0, got {self.drift_threshold}")
        if self.adapt_interval < 0:
            raise ValueError(f"adapt_interval must be >= 0, got {self.adapt_interval}")
        if self.adapt_granularity not in ("type", "worker"):
            raise ValueError(
                f"adapt_granularity must be 'type' or 'worker', got {self.adapt_granularity!r}"
            )


@dataclass
class PreRound:
    """What the producer learns before assigning a round."""

    round_idx: int
    stall_s: float = 0.0
    stalled: bool = False
    fallback: bool = False  # place with BB until the model recovers


class ControlPlane:
    """Closed-loop controller for one :class:`FederatedEngine` (or the
    simcluster scenario harness — anything with the same call shape)."""

    def __init__(self, cfg: ControllerConfig, *, placement, pool=None):
        self.cfg = cfg
        self.placement = placement
        self.pool = pool
        self.measured = (
            MeasuredTelemetry(policy=cfg.barrier_policy, stall_timeout_s=cfg.stall_timeout_s)
            if cfg.telemetry_mode == "measured"
            else None
        )
        self.drift = (
            DriftDetector(
                threshold=cfg.drift_threshold,
                window=cfg.drift_window,
                recover_fraction=cfg.drift_recover_fraction,
                min_points=cfg.drift_min_points,
            )
            if cfg.drift_threshold > 0
            else None
        )
        self.autoconc = (
            AdaptiveConcurrency(
                interval=cfg.adapt_interval,
                min_slots=cfg.adapt_min_slots,
                max_slots=cfg.adapt_max_slots,
                min_gain=cfg.adapt_min_gain,
            )
            if cfg.adapt_interval > 0
            else None
        )
        self.fallback_placement = BatchesBasedPlacement()
        self.fallback_rounds = 0
        self.log: list = []  # (round, kind, detail)
        # Per-worker residual EWMAs (mesh path: |meas - pred| / pred of each
        # worker's exact wall time) — observability for which worker drifts.
        self.worker_residuals: dict = {}  # wid -> ewma
        # Tombstones for failed wids: pending worker meta recorded before
        # the failure must not resurrect a dead worker's residual when it
        # flushes after the pool event (cleared when the wid rejoins).
        self._dead_wids: set = set()
        self.cache_rebalances = 0  # orphan-shard pool reclaims observed
        # Compressed-combine journal (consumer-owned, separate from
        # self.log: the producer appends to self.log in round order and a
        # consumer-side append would interleave across threads).
        self.compress_log: list = []  # (round, bytes_sent, residual_norm)
        if self.autoconc is not None and pool is not None:
            # Seed each knob at its current (estimated) slot count — the
            # engine's pool carries the Table-3 / analytic-estimate values.
            # Granularity "worker" gives every wid its own knob (follow-on
            # (d): per-worker rather than per-type slots — the hill climb
            # still scores the shared round-throughput objective).
            for w in pool.workers.values():
                self.autoconc.seed(self._slot_key(w.type_name, w.wid), w.concurrency)

    def _slot_key(self, type_name: str, wid) -> str:
        if self.cfg.adapt_granularity == "worker":
            return f"w{int(wid)}"
        return type_name

    # -- producer side (strict round order) ----------------------------------
    def pre_round(self, t: int) -> PreRound:
        """Flush barrier-released telemetry into the model, update drift and
        concurrency, and report whether placement should fall back."""
        info = PreRound(round_idx=t)
        if self.measured is not None:
            out = self.measured.flush(t)
            info.stall_s, info.stalled = out.stall_s, out.stalled
            self._ingest_measured(t, out)
        if self.autoconc is not None:
            for key, old, new in self.autoconc.maybe_update(t):
                self._apply_slots(key, new)
                self.log.append((t, "slots", f"{key}: {old} -> {new}"))
        if self.drift is not None and self.drift.drifted:
            info.fallback = True
            self.fallback_rounds += 1
        return info

    def _ingest_measured(self, t: int, out) -> None:
        by_type: dict[str, list] = {}
        for rnd, tname, x, sec in out.rows:
            by_type.setdefault(tname, []).append((x, sec))
            if isinstance(self.placement, LearningBasedPlacement):
                self.placement.observe_type(rnd, tname, x, sec)
        if self.drift is not None:
            self._update_drift(t, by_type)
        # Mesh path: fold each worker's exact (predicted, measured) pair
        # into its residual EWMA — which *worker* mispredicts, not just
        # which type.  Producer-side, round order (rides the same flush).
        # Dead wids are skipped: their pending meta was discarded at the
        # pool event, and this filter is the belt for rows recorded in the
        # same flush window.
        for _, wid, _, pred_s, meas_s in out.worker_meta:
            if wid in self._dead_wids:
                continue
            if pred_s > 0:
                err = abs(meas_s - pred_s) / pred_s
                prev = self.worker_residuals.get(wid)
                alpha = 2.0 / (self.cfg.drift_window + 1.0)
                self.worker_residuals[wid] = (
                    err if prev is None else (1 - alpha) * prev + alpha * err
                )
        if self.autoconc is not None:
            for _, exec_s, n_steps, _ in out.round_meta:
                if exec_s > 0:
                    self.autoconc.observe_round(n_steps / exec_s)

    def round_prepared(self, t: int, *, makespan: float, n_clients: int, rows=None) -> None:
        """Synthetic-mode feedback: the simulated times drawn at prepare time
        ARE the ground truth, so drift/concurrency read them directly (still
        producer-side, still round order — depth cannot reorder this)."""
        if self.measured is not None:
            return  # measured mode feeds through round_executed/flush
        if self.drift is not None and rows:
            by_type: dict[str, list] = {}
            for tname, x, sec in rows:
                by_type.setdefault(tname, []).append((x, sec))
            self._update_drift(t, by_type)
        if self.autoconc is not None and makespan > 0:
            self.autoconc.observe_round(n_clients / makespan)

    def _update_drift(self, t: int, by_type: dict) -> None:
        if not isinstance(self.placement, LearningBasedPlacement):
            return
        for tname, pairs in by_type.items():
            model = self.placement.models.get(tname)
            if model is None or not model.ready:
                continue
            xs = np.asarray([p[0] for p in pairs], dtype=np.float64)
            ts = np.asarray([p[1] for p in pairs], dtype=np.float64)
            self.drift.update(t, tname, relative_errors(model.predict(xs), ts))

    def _apply_slots(self, key: str, slots: int) -> None:
        """Apply a slot move: ``key`` is a type name (granularity "type")
        or ``"w<wid>"`` (granularity "worker")."""
        if self.pool is None:
            return
        if self.cfg.adapt_granularity == "worker":
            wid = int(key[1:])
            w = self.pool.workers.get(wid)
            if w is not None:
                self.pool.workers[wid] = replace(w, concurrency=slots)
            return
        for wid, w in list(self.pool.workers.items()):
            if w.type_name == key:
                self.pool.workers[wid] = replace(w, concurrency=slots)

    def on_pool_events(self, t: int, events) -> None:
        """Elastic fail/join: reset the affected type's drift evidence and
        (re)seed its slot count.  (The time model itself needs no bootstrap:
        models are per *type*, so a joining worker of a known type inherits
        the pooled telemetry of its peers — test-enforced in
        ``tests/test_elastic.py``.)"""
        for e in events:
            tname = getattr(e, "type_name", "default")
            wid = getattr(e, "wid", -1)
            if self.drift is not None:
                self.drift.reset(tname, t)
            if e.kind == "fail":
                self.worker_residuals.pop(wid, None)
                self._dead_wids.add(wid)
                if self.measured is not None:
                    self.measured.discard_workers([wid])
            elif e.kind == "join":
                self._dead_wids.discard(wid)
            if self.autoconc is not None:
                key = self._slot_key(tname, wid)
                if e.kind == "join":
                    self.autoconc.seed(key, getattr(e, "concurrency", 1))
                    # A join into an already-tuned knob must run at the
                    # climber's current slot count, not the event's guess —
                    # mixed concurrency would skew the next window's
                    # throughput comparison.  (seed() is a no-op for known
                    # keys, so this is the only place that aligns it.)
                    tuned = self.autoconc.slots_for(key)
                    if tuned is not None:
                        self._apply_slots(key, tuned)
                elif self.cfg.adapt_granularity == "worker":
                    # The failed worker's knob is gone with it.
                    self.autoconc.forget(key)
                elif self.pool is not None and not any(
                    w.type_name == tname for w in self.pool.workers.values()
                ):
                    self.autoconc.forget(tname)
            self.log.append((t, e.kind, tname))

    def on_cache_rebalance(self, t: int, event: dict) -> None:
        """Journal an orphan-shard pool rebalance (engine-reported,
        producer-side): which shards are live and where the row budget
        went.  Keeps the control log a complete account of why cache (and
        therefore placement-affinity) behavior changed at round ``t``."""
        self.cache_rebalances += 1
        self.log.append(
            (
                t,
                "cache_rebalance",
                f"live={event.get('live_shards')} "
                f"capacities={event.get('capacities')} "
                f"rows_moved={event.get('rows_moved')}",
            )
        )

    # -- consumer side -------------------------------------------------------
    def round_executed(
        self, t: int, exec_s: float, shares, n_steps: int, *, rows=None, worker_times=None
    ) -> None:
        """Consumer hook, called right after round ``t``'s device sync.

        ``rows`` carries exact per-client ``(worker_type, x, seconds)``
        measurements when the caller has them (real clusters, the simcluster
        harness); ``worker_times`` carries the mesh path's exact per-worker
        ``(wid, worker_type, xs, pred_s, meas_s)`` entries (one per synced
        worker program).  Only without either does ``exec_s`` fall back to
        predicted-share attribution across ``shares``."""
        if self.measured is None:
            return
        if worker_times is not None:
            self.measured.record_worker_times(t, worker_times, exec_s=exec_s, n_steps=n_steps)
        elif rows is not None:
            self.measured.record_rows(t, rows, exec_s=exec_s)
        else:
            self.measured.record(t, exec_s, shares, n_steps)

    def on_combine_compressed(
        self, t: int, *, bytes_sent: int, residual_norm: float
    ) -> None:
        """Consumer hook (mesh path, ``combine_compress != "none"``): journal
        round ``t``'s compressed cross-shard combine — the bytes that
        actually crossed the shard→root boundary and the L2 norm of the
        error-feedback residual set after the round.  A growing residual
        norm is the early-warning signal that the compressor is too
        aggressive for the current update distribution."""
        self.compress_log.append((t, int(bytes_sent), float(residual_norm)))

    # -- lifecycle -----------------------------------------------------------
    def begin_run(self, first_round: int) -> None:
        if self.measured is not None:
            self.measured.begin_run(first_round)

    def abort(self) -> None:
        if self.measured is not None:
            self.measured.abort()

    def reset(self, round_idx: int) -> None:
        """Checkpoint restore WITHOUT a persisted controller snapshot (the
        fallback path — :meth:`load_state` is the exact resume): the rounds
        about to replay already fed every feedback path once — drop pending
        measured rows, drift evidence, and the open throughput window, or
        the replay double-counts them."""
        if self.measured is not None:
            self.measured.reset(round_idx)
        if self.drift is not None:
            self.drift.reset_all(round_idx)
        if self.autoconc is not None:
            self.autoconc.restart_window()

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-safe snapshot of the whole control loop, taken producer-side
        at the end of a round's prep (after every control mutation of that
        round).  The engine adopts it at finish time and persists it in the
        checkpoint's aux sidecar, so a restore resumes drift EWMAs
        mid-hysteresis, the slot-count trajectory, and the pending measured
        rows — instead of re-warming from zero."""
        state: dict = {
            "fallback_rounds": self.fallback_rounds,
            "cache_rebalances": self.cache_rebalances,
            "worker_residuals": {
                str(int(w)): float(e) for w, e in self.worker_residuals.items()
            },
            "dead_wids": sorted(int(w) for w in self._dead_wids),
        }
        if self.drift is not None:
            state["drift"] = self.drift.state_dict()
        if self.autoconc is not None:
            state["autoconc"] = self.autoconc.state_dict()
        if self.measured is not None:
            state["measured"] = self.measured.state_dict()
        return state

    def load_state(self, state: dict, round_idx: int) -> None:
        """Checkpoint restore into a run resuming at ``round_idx``: adopt a
        :meth:`state_dict` snapshot.  Restored slot counts are re-applied to
        the worker pool (pool concurrency is live state the checkpoint does
        not carry); consumer-side rows recorded after the snapshot was taken
        (at most the in-flight pipeline depth's worth) are gone — strictly
        less loss than :meth:`reset`, which drops everything."""
        self.fallback_rounds = int(state.get("fallback_rounds", 0))
        self.cache_rebalances = int(state.get("cache_rebalances", 0))
        self.worker_residuals = {
            int(w): float(e) for w, e in (state.get("worker_residuals") or {}).items()
        }
        self._dead_wids = {int(w) for w in state.get("dead_wids") or []}
        if self.drift is not None and state.get("drift") is not None:
            self.drift.load_state(state["drift"])
        if self.autoconc is not None and state.get("autoconc") is not None:
            self.autoconc.load_state(state["autoconc"])
            for key, st in self.autoconc.states.items():
                self._apply_slots(key, st.slots)
        if self.measured is not None:
            if state.get("measured") is not None:
                self.measured.load_state(state["measured"], round_idx)
            else:
                self.measured.reset(round_idx)

    # -- reading -------------------------------------------------------------
    @property
    def fallback_active(self) -> bool:
        return self.drift is not None and self.drift.drifted

    def audit(self) -> list[str]:
        return audit_violations(self.measured) if self.measured is not None else []

    def stats(self) -> dict:
        out: dict = {
            "telemetry_mode": self.cfg.telemetry_mode,
            "fallback_rounds": self.fallback_rounds,
            "events": len(self.log),
            "cache_rebalances": self.cache_rebalances,
        }
        if self.measured is not None:
            out["barrier"] = self.measured.stats()
            out["audit_violations"] = len(self.audit())
        if self.drift is not None:
            out["drift"] = self.drift.stats()
        if self.compress_log:
            out["combine_compress"] = {
                "rounds": len(self.compress_log),
                "bytes_sent": int(sum(b for _, b, _ in self.compress_log)),
                "last_residual_norm": float(self.compress_log[-1][2]),
            }
        if self.worker_residuals:
            out["worker_residuals"] = {
                int(w): float(e) for w, e in sorted(self.worker_residuals.items())
            }
        if self.autoconc is not None:
            out["concurrency"] = self.autoconc.stats()
            out["adapt_granularity"] = self.cfg.adapt_granularity
        return out
