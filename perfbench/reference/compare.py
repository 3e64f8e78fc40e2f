"""The numbers that decide ``correct`` for a training cell.

The program trains rounds 1..R from the benchmark's weights θ0; the plain
reference (:mod:`perfbench.reference.fl`) trains the same rounds from the
same θ0 on the same traffic.  Three numbers compare them:

* ``loss1_gap``: the relative gap of round 1's loss, ``|loss_p -
  loss_r| / |loss_r|``.  Only round 1's: in later rounds a rounding
  carried forward through the clients' steps grows until the program's
  gap (up to ~8e-5 at the cells' sizes) overlaps the gap of the reference
  in TF32 (as low as ~8e-6), so no limit separates them there, while
  round 1's, whose client steps all start from θ0, differ by ~1e-6
  against ~1e-4 (:func:`loss_gaps` reads every round for the limits);
* ``delta1_gap``: the first update as the server applies it, ``Δ1 = θ0 -
  θ1``, by the worst leaf: ``|‖Δ1_p‖ - ‖Δ1_r‖| / max(‖Δ1_r‖, median
  leaf's ‖Δ1_r‖)``;
* ``deltaR_gap``: the same for the change after the R rounds, ``θ0 - θR``.

Leaves whose reference update is nought to rounding (``‖Δ1_r‖`` under a
thousandth of the median leaf's) are left out of both update gaps; the
rule reads the reference alone.
"""

from __future__ import annotations

import math

__all__ = ["numbers", "loss_gaps", "NAMES"]

NAMES = ("loss1_gap", "delta1_gap", "deltaR_gap")


def _norms(theta0: dict, theta: dict) -> dict:
    return {k: float((theta0[k].double() - theta[k].double()).norm())
            for k in theta0}


def _worst_leaf(prog: dict, ref: dict, kept) -> float:
    med = sorted(ref[k] for k in kept)[len(kept) // 2]
    gap = 0.0
    for k in kept:
        d = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        gap = max(gap, d if math.isfinite(d) else math.inf)
    return gap


def loss_gaps(prog: dict, ref: dict) -> list:
    """Every round's relative loss gap (round 1's is ``loss1_gap``); the
    later ones are read for the limits, not compared."""
    return [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref["losses"])]


def numbers(theta0: dict, prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``{"losses": [R], "theta1": {...}, "thetaR":
    {...}}``, leaves on the host keyed alike.  Returns the three gaps (a
    non-finite reading comes back as ``inf``)."""
    t0 = {k: v.cpu() for k, v in theta0.items()}
    lp, lr = prog["losses"][0], ref["losses"][0]
    loss = abs(lp - lr) / max(abs(lr), 1e-30)
    r1, rR = _norms(t0, ref["theta1"]), _norms(t0, ref["thetaR"])
    p1, pR = _norms(t0, prog["theta1"]), _norms(t0, prog["thetaR"])
    med = sorted(r1.values())[len(r1) // 2]
    kept = [k for k in r1 if r1[k] >= 1e-3 * med]
    return {"loss1_gap": loss if math.isfinite(loss) else math.inf,
            "delta1_gap": _worst_leaf(p1, r1, kept),
            "deltaR_gap": _worst_leaf(pR, rR, kept)}
