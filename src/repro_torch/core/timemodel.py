"""Pollen's learning-based client-training-time model (paper Eq. 3 and Eq. 4).

The model predicts, per worker *type*, the wall-clock time to train one client
from the number of batches ``x`` the client holds:

    f(x) = a*x + b*log(c*x) + d                                    (Eq. 3)

fit by least squares on telemetry tuples ``(x, time)``.  The paper motivates
the log-linear form over polynomials because it (i) never goes negative for
the dense cloud of small clients and (ii) degrades gracefully to linear.

Adaptive error correction (Eq. 4) blends the fit with the mean of recent
observations:

    g(x) = 1/2 * ( f(x) + mean(recent window) )

No scipy is available, so the fit is our own separable least squares: for a
fixed ``c`` the model is *linear* in (a, b, d), solved in closed form with
``numpy.linalg.lstsq``; the scalar ``c`` is optimized by golden-section search
over log-space.  This is fast (<1 ms for thousands of points), deterministic,
and robust — exactly what the paper needs since the fit re-runs every round.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "LogLinearFit",
    "fit_log_linear",
    "fit_linear",
    "TrainingTimeModel",
]

_GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0


@dataclass(frozen=True)
class LogLinearFit:
    """Parameters of Eq. 3 plus the fit's summed squared error."""

    a: float
    b: float
    c: float
    d: float
    sse: float

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float64)
        return self.a * x + self.b * np.log(self.c * x) + self.d

    def predict(self, x):
        """Predict training time; clipped at a small positive floor.

        The paper chose Eq. 3 so the fitted curve "never predicts negative
        values"; numerically b can still be slightly negative on degenerate
        data, so we keep the explicit floor as a safety net.
        """
        return np.maximum(self(x), 1e-6)


def _solve_linear_in_abd(x: np.ndarray, t: np.ndarray, c: float):
    """For fixed c, Eq. 3 is linear in (a, b, d): solve by lstsq."""
    logcx = np.log(c * x)
    design = np.stack([x, logcx, np.ones_like(x)], axis=1)
    coef, _, _, _ = np.linalg.lstsq(design, t, rcond=None)
    resid = design @ coef - t
    return coef, float(resid @ resid)


def fit_log_linear(x, t, *, c_lo: float = 1e-4, c_hi: float = 1e4,
                   iters: int = 60) -> LogLinearFit:
    """Fit Eq. 3 by separable least squares.

    Note ``b*log(c*x) = b*log(x) + b*log(c)``: ``c`` is only identifiable
    jointly with ``d`` (it shifts the intercept).  We still search ``c`` in
    log-space as the paper parameterizes it, which also keeps ``log(c*x)``
    well-conditioned for typical batch counts.
    """
    x = np.asarray(x, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    if x.ndim != 1 or x.shape != t.shape:
        raise ValueError(f"x and t must be 1-D and equal length, got {x.shape} vs {t.shape}")
    if x.size < 3:
        # Degenerate: fall back to a constant model.
        mean_t = float(t.mean()) if t.size else 0.0
        return LogLinearFit(a=0.0, b=0.0, c=1.0, d=mean_t, sse=float(((t - mean_t) ** 2).sum()))
    if np.any(x <= 0):
        raise ValueError("batch counts must be positive")

    # Golden-section search over log10(c).
    lo, hi = math.log10(c_lo), math.log10(c_hi)

    def sse_at(logc: float) -> float:
        _, sse = _solve_linear_in_abd(x, t, 10.0 ** logc)
        return sse

    p = hi - _GOLDEN * (hi - lo)
    q = lo + _GOLDEN * (hi - lo)
    fp, fq = sse_at(p), sse_at(q)
    for _ in range(iters):
        if fp <= fq:
            hi, q, fq = q, p, fp
            p = hi - _GOLDEN * (hi - lo)
            fp = sse_at(p)
        else:
            lo, p, fp = p, q, fq
            q = lo + _GOLDEN * (hi - lo)
            fq = sse_at(q)
    c = 10.0 ** ((lo + hi) / 2.0)
    (a, b, d), sse = _solve_linear_in_abd(x, t, c)
    return LogLinearFit(a=float(a), b=float(b), c=float(c), d=float(d), sse=sse)


@dataclass(frozen=True)
class LinearFit:
    """Plain linear baseline t = a*x + d (the paper's Fig. 7 comparison,
    also Parrot's model)."""

    a: float
    d: float
    sse: float

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float64)
        return self.a * x + self.d

    def predict(self, x):
        return np.maximum(self(x), 1e-6)


def fit_linear(x, t) -> LinearFit:
    x = np.asarray(x, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64)
    if x.size < 2:
        mean_t = float(t.mean()) if t.size else 0.0
        return LinearFit(a=0.0, d=mean_t, sse=float(((t - mean_t) ** 2).sum()))
    design = np.stack([x, np.ones_like(x)], axis=1)
    coef, _, _, _ = np.linalg.lstsq(design, t, rcond=None)
    resid = design @ coef - t
    return LinearFit(a=float(coef[0]), d=float(coef[1]), sse=float(resid @ resid))


@dataclass
class TrainingTimeModel:
    """Per-worker-type online time model with the paper's round protocol.

    * Rounds 1–2 use Round-Robin placement to gather unbiased telemetry
      (§4.2); the model reports ``ready == False`` until it has fit data.
    * The fit for round ``t`` only uses telemetry from rounds ``<= t - 2``
      because fitting happens while round ``t-1`` trains (§4.2).
    * Eq. 4 corrects ``f`` with the mean of the most recent ``window`` rounds
      of residual-relevant data (the paper uses the most recent round).
    """

    window: int = 1
    max_points: int | None = None  # optional telemetry retention limit (§4.2.1)
    x_bin: float = 1.0             # bin width for "same x" in the Eq. 4 correction
    min_bin_count: int = 3         # Eq. 4 applies only where the recent
                                   # window actually has data; singleton bins
                                   # would inject the observation noise the
                                   # robust fit exists to smooth out
    _xs: list = field(default_factory=list)      # [(round, x, time)]
    _fit: LogLinearFit | None = None
    _fit_round: int = -1
    _recent_by_x: dict = field(default_factory=dict)  # bin -> mean recent time
    fit_count: int = 0             # full (non-reused) Eq. 3 solves so far
    _n_trimmed: int = 0            # rows dropped by max_points retention
    # Fast-path signatures: _xs is append-only except for retention trims,
    # so (rows trimmed, usable-row count) pins the usable set exactly, and
    # adding the cutoff pins the Eq. 4 recent window.
    _fit_sig: tuple = (-1, -1)
    _recent_sig: tuple = (-1, -1, -1)

    # -- telemetry ---------------------------------------------------------
    def observe(self, round_idx: int, x, t) -> None:
        x = np.atleast_1d(np.asarray(x, dtype=np.float64))
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        for xi, ti in zip(x, t):
            self._xs.append((int(round_idx), float(xi), float(ti)))
        if self.max_points is not None and len(self._xs) > self.max_points:
            self._n_trimmed += len(self._xs) - self.max_points
            self._xs = self._xs[-self.max_points:]

    @property
    def n_points(self) -> int:
        return len(self._xs)

    # -- fitting -----------------------------------------------------------
    def refit(self, current_round: int) -> None:
        """Fit Eq. 3 on data from rounds <= current_round - 2 and compute the
        Eq. 4 recent-window mean.  Call once per round (host-side, overlapped
        with device execution).

        Incremental: when no usable telemetry arrived since the last call
        (e.g. the control plane's refit barrier released nothing under the
        ``"reuse"`` policy), the previous fit — and, if the cutoff did not
        move either, the Eq. 4 window — is reused without recomputation, so
        "deterministically reuse the last fit" costs O(n) row filtering
        instead of a least-squares solve.  ``fit_count`` counts only the
        full solves."""
        cutoff = current_round - 2
        pts = [(x, t) for (r, x, t) in self._xs if r <= cutoff]
        sig = (self._n_trimmed, len(pts))
        if len(pts) >= 3 and sig != self._fit_sig:
            xs = np.array([p[0] for p in pts])
            ts = np.array([p[1] for p in pts])
            self._fit = fit_log_linear(xs, ts)
            self._fit_sig = sig
            self.fit_count += 1
        if self._fit is not None:
            self._fit_round = current_round
        # Eq. 4 correction data: "the average training time for x observed in
        # recent data" — binned by batch count over the recent window.
        rsig = (self._n_trimmed, len(pts), cutoff)
        if rsig == self._recent_sig:
            return
        buckets: dict[int, list[float]] = {}
        for (r, x, t) in self._xs:
            if cutoff - self.window < r <= cutoff:
                buckets.setdefault(int(round(x / self.x_bin)), []).append(t)
        self._recent_by_x = {k: float(np.mean(v)) for k, v in buckets.items()
                             if len(v) >= self.min_bin_count}
        self._recent_sig = rsig

    @property
    def ready(self) -> bool:
        return self._fit is not None

    @property
    def fit(self) -> LogLinearFit | None:
        return self._fit

    # -- prediction --------------------------------------------------------
    def predict(self, x):
        """g(x) of Eq. 4; falls back to f(x) for x unseen in the window."""
        if self._fit is None:
            raise RuntimeError("model not fit yet; use RR placement for warm-up rounds")
        x_arr = np.atleast_1d(np.asarray(x, dtype=np.float64))
        f = self._fit.predict(x_arr)
        g = f.copy()
        for i, xi in enumerate(x_arr):
            key = int(round(xi / self.x_bin))
            recent = self._recent_by_x.get(key)
            if recent is not None:
                g[i] = 0.5 * (f[i] + recent)
        return g if np.ndim(x) else float(g[0])
