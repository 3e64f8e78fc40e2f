"""Arrival index: who is online at round t, without materializing anyone.

The open-world arrival process composes three deterministic pieces:

* per-region :class:`~repro_torch.simcluster.profiles.AvailabilityTrace` diurnal
  rate curves (the *rate* half),
* the store's hash ``phase(cid)`` threshold (the *membership* half):
  client c is online at t iff ``phase(c) < rate(region(c), t)`` — the
  nested-threshold rule, so a rising rate only ever ADDS clients and the
  same devices recur night after night (stable membership, cache-friendly),
* :class:`Intervention` storms that scale a region's (or the globe's) rate
  over a round window: a **surge** multiplies the rate above 1x, an
  **outage** crushes it toward 0.

Everything is a pure function of (cid, t, config): ``online`` costs O(#ids
probed), ``expected_online`` is the analytic expectation
``population * sum_r weight_r * rate_r(t)`` (an expectation, not a census —
counting would be the O(N) scan this module exists to avoid).  The index
also keeps a ``probes`` counter so tests and the population benchmark can
assert the per-round probe volume stays bounded by the sampler's draw
budget, independent of population size.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from repro_torch.simcluster.profiles import REGIONS, AvailabilityTrace

from .store import ClientMetadataStore

__all__ = ["ArrivalIndex", "Intervention"]


@dataclass(frozen=True)
class Intervention:
    """One scenario storm: scale a region's online rate over [start, end).

    ``region=None`` applies globally.  ``scale > 1`` is an arrival surge,
    ``scale ~ 0`` a (regional) outage; overlapping interventions multiply.
    """

    kind: str                # "surge" | "outage" (labelling only)
    start: int
    end: int                 # exclusive
    scale: float
    region: str | None = None

    def __post_init__(self):
        if self.end <= self.start:
            raise ValueError("intervention window must be non-empty")
        if self.scale < 0:
            raise ValueError("scale must be >= 0")

    def active(self, t: float) -> bool:
        return self.start <= t < self.end

    def to_dict(self) -> dict:
        return {"kind": self.kind, "start": self.start, "end": self.end,
                "scale": self.scale, "region": self.region}

    @classmethod
    def from_dict(cls, d: dict) -> "Intervention":
        return cls(kind=d["kind"], start=d["start"], end=d["end"],
                   scale=d["scale"], region=d.get("region"))


class ArrivalIndex:
    """Streaming online/offline oracle over a :class:`ClientMetadataStore`."""

    def __init__(self, store: ClientMetadataStore, *,
                 traces: dict[str, AvailabilityTrace] | None = None,
                 interventions: tuple = (), period: float | None = None):
        self.store = store
        traces = dict(traces) if traces is not None else {
            name: REGIONS[name] for name in store.region_names}
        missing = [n for n in store.region_names if n not in traces]
        if missing:
            raise ValueError(f"no availability trace for region(s) {missing}")
        if period is not None:
            traces = {n: replace(tr, period=float(period))
                      for n, tr in traces.items()}
        self.traces = traces
        self.interventions = tuple(interventions)
        for iv in self.interventions:
            if iv.region is not None and iv.region not in traces:
                raise ValueError(f"intervention names unknown region "
                                 f"{iv.region!r}")
        self.probes = 0          # ids probed via online() — boundedness gauge

    # -- rates -------------------------------------------------------------
    def online_fraction(self, region: str, t: float) -> float:
        """The region's online rate at round t, storms applied, in [0, 1]."""
        f = self.traces[region].online_fraction(t)
        for iv in self.interventions:
            if iv.active(t) and iv.region in (None, region):
                f *= iv.scale
        return min(1.0, max(0.0, f))

    def _fractions(self, t: float) -> np.ndarray:
        return np.asarray([self.online_fraction(r, t)
                           for r in self.store.region_names])

    # -- membership --------------------------------------------------------
    def online(self, cids, t: float) -> np.ndarray:
        """Boolean mask: which of ``cids`` are online at round t (O(#cids))."""
        cids = np.atleast_1d(np.asarray(cids))
        self.probes += int(cids.size)
        rates = self._fractions(t)[self.store.region_idx(cids)]
        return self.store.phase(cids) < rates

    def expected_online(self, t: float) -> float:
        """Analytic expected online-pool size (expectation, not a census)."""
        weights = np.asarray([self.traces[r].weight
                              for r in self.store.region_names])
        weights = weights / weights.sum()
        return float(self.store.population
                     * float(weights @ self._fractions(t)))

    # -- checkpoint state --------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "store": self.store.state_dict(),
            "traces": {n: {"name": tr.name, "weight": tr.weight,
                           "base": tr.base, "amplitude": tr.amplitude,
                           "phase": tr.phase, "period": tr.period}
                       for n, tr in self.traces.items()},
            "interventions": [iv.to_dict() for iv in self.interventions],
        }

    @classmethod
    def from_state(cls, state: dict) -> "ArrivalIndex":
        traces = {n: AvailabilityTrace(**d)
                  for n, d in state["traces"].items()}
        store = ClientMetadataStore.from_state(state["store"], regions=traces)
        ivs = tuple(Intervention.from_dict(d)
                    for d in state.get("interventions", ()))
        return cls(store, traces=traces, interventions=ivs)
