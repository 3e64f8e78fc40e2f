"""Prediction-drift detection for the fitted time model.

The log-linear fit (Eq. 3/4) is only as good as the telemetry it was fit
on.  Worker churn, a workload shift (``ZipfSampler`` turning a different
client population hot), or a cluster-side slowdown (stragglers, thermal
throttling) all make yesterday's model mispredict today's times — and a
placement driven by a stale model is *worse* than the batches-based
baseline it is supposed to beat.

:class:`DriftDetector` watches the relative residuals ``|t - f(x)| / f(x)``
of every fresh observation against the prediction made *before* that
observation entered the model (the engine computes residuals at the point
where the fit still predates the data, so they are genuinely
out-of-sample).  Per worker type it keeps an EWMA of the residuals; when
the EWMA crosses ``threshold`` the type is marked *drifted*, and the
control plane answers ``fallback_active`` — the engine places with
:class:`~repro_torch.core.placement.BatchesBasedPlacement` until the refit has
caught up and the EWMA has recovered below
``threshold * recover_fraction`` (hysteresis, so the placement does not
flap).  Pool fail/join events reset the affected type's statistics: a
changed pool invalidates the evidence, not the model.

On the mesh execution path the residuals feeding this detector derive from
**exact per-worker wall times** (one device sync per worker program)
rather than round-level attribution, and the control plane additionally
keeps a per-*worker* residual EWMA (``ControlPlane.worker_residuals``) so
a single degraded worker is visible even when its type's pooled EWMA
stays calm.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["DriftDetector", "DriftState", "relative_errors"]


@dataclass
class DriftState:
    """Residual statistics for one worker type."""

    ewma: float = 0.0
    n: int = 0
    drifted: bool = False
    since_round: int = -1  # round the current drift episode started


@dataclass
class DriftDetector:
    """EWMA residual monitor with hysteresis, one state per worker type."""

    threshold: float = 0.5  # relative-error EWMA that trips the alarm
    window: int = 16  # EWMA effective window (alpha = 2 / (window + 1))
    recover_fraction: float = 0.5  # recover below threshold * fraction
    min_points: int = 8  # observations before the alarm may trip
    states: dict = field(default_factory=dict)  # type -> DriftState
    events: list = field(default_factory=list)  # (round, type, kind, ewma)

    def __post_init__(self):
        if self.threshold < 0:
            raise ValueError(f"threshold must be >= 0, got {self.threshold}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")

    def _state(self, type_name: str) -> DriftState:
        if type_name not in self.states:
            self.states[type_name] = DriftState()
        return self.states[type_name]

    # -- feeding -------------------------------------------------------------
    def update(self, round_idx: int, type_name: str, rel_errors) -> None:
        """Fold one round's out-of-sample relative errors for one type."""
        errs = np.atleast_1d(np.asarray(rel_errors, dtype=np.float64))
        if errs.size == 0:
            return
        st = self._state(type_name)
        alpha = 2.0 / (self.window + 1.0)
        for e in errs:
            st.ewma = float(e) if st.n == 0 else (1 - alpha) * st.ewma + alpha * float(e)
            st.n += 1
        if self.threshold <= 0:
            return
        if not st.drifted and st.n >= self.min_points and st.ewma > self.threshold:
            st.drifted = True
            st.since_round = round_idx
            self.events.append((round_idx, type_name, "drift", st.ewma))
        elif st.drifted and st.ewma < self.threshold * self.recover_fraction:
            st.drifted = False
            self.events.append((round_idx, type_name, "recover", st.ewma))

    def reset(self, type_name: str, round_idx: int = -1) -> None:
        """Pool event (fail/join) for this type: the evidence is stale."""
        if type_name in self.states:
            was = self.states[type_name].drifted
            self.states[type_name] = DriftState()
            if was:
                self.events.append((round_idx, type_name, "reset", 0.0))

    def reset_all(self, round_idx: int = -1) -> None:
        """Checkpoint restore: replayed rounds would double-count their
        residuals, so the evidence restarts from zero (re-warm)."""
        for tname in list(self.states):
            self.reset(tname, round_idx)

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-safe snapshot of every type's EWMA state (mid-hysteresis
        included: a drifted type resumes drifted, with its episode round)."""
        return {
            "states": {
                t: [s.ewma, s.n, s.drifted, s.since_round]
                for t, s in self.states.items()
            },
            "events": [list(e) for e in self.events],
        }

    def load_state(self, state: dict) -> None:
        """Checkpoint restore: adopt a snapshot taken by :meth:`state_dict`."""
        self.states = {
            str(t): DriftState(
                ewma=float(v[0]),
                n=int(v[1]),
                drifted=bool(v[2]),
                since_round=int(v[3]),
            )
            for t, v in (state.get("states") or {}).items()
        }
        self.events = [tuple(e) for e in state.get("events") or []]

    # -- reading -------------------------------------------------------------
    @property
    def drifted(self) -> bool:
        return any(s.drifted for s in self.states.values())

    def drifted_types(self) -> list[str]:
        return sorted(t for t, s in self.states.items() if s.drifted)

    def stats(self) -> dict:
        return {
            "drifted": self.drifted,
            "drifted_types": self.drifted_types(),
            "ewma": {t: s.ewma for t, s in sorted(self.states.items())},
            "events": len(self.events),
        }


def relative_errors(predicted, observed, *, floor: float = 1e-6) -> np.ndarray:
    """``|t - f(x)| / f(x)`` with the same positive floor the model uses."""
    p = np.maximum(np.atleast_1d(np.asarray(predicted, dtype=np.float64)), floor)
    t = np.atleast_1d(np.asarray(observed, dtype=np.float64))
    return np.abs(t - p) / p
