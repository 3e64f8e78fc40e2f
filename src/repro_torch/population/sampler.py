"""Streaming cohort sampler over the currently-online pool.

``OnlinePoolSampler`` draws each round's cohort by rejection sampling
against the arrival index: draw uniform candidate ids, keep the online
ones, stop when the cohort is full or the draw budget
(``max_draw_factor * cohort_size``) is spent.  The expected cost is
``cohort / online_rate`` probes — O(cohort), never O(population) — and the
registry is never materialized (the probe counter on the index lets tests
assert exactly that).

When the online pool cannot fill the cohort inside the budget (a regional
outage, a global blackout, or simply ``rate ~ 0`` at the diurnal trough),
the remainder is filled with *offline* clients — deterministically, never
an infinite loop — and reported as the round's ``stale`` count.  That is
the deadline-SLO story: a production FL round facing an empty pool drafts
stale devices (whose updates arrive late or not at all), and
``stale_fraction`` in :class:`~repro_torch.core.engine.RoundResult` is the
metric that says how often the simulated deployment had to.

Determinism contract (same as Uniform/Zipf): the only mutable state is one
numpy Generator, advanced exclusively inside :meth:`sample`, which the
engine calls on the producer thread in strict round order — so cohorts are
bit-identical across pipeline depths 0/1/2 and checkpoint round-trips via
``sampler_state`` / ``restore_sampler`` resume the exact stream.
``last_stats`` (stale/online/draw counts + the analytic pool size) is
overwritten per sample; the engine snapshots it immediately after the
cohort draw, on the same thread.
"""

from __future__ import annotations

import numpy as np

from .arrival import ArrivalIndex

__all__ = ["OnlinePoolSampler"]


class OnlinePoolSampler:
    def __init__(self, index: ArrivalIndex, cohort_size: int, *,
                 seed: int = 1337, max_draw_factor: int = 64):
        if cohort_size <= 0:
            raise ValueError("cohort_size must be positive")
        if max_draw_factor < 1:
            raise ValueError("max_draw_factor must be >= 1")
        self.index = index
        self.population = index.store.population
        self.cohort_size = int(cohort_size)
        self.seed = int(seed)
        self.max_draw_factor = int(max_draw_factor)
        self.rng = np.random.default_rng(seed)
        self.with_replacement = cohort_size > self.population
        self.last_stats: dict = {}

    def sample(self, round_idx: int) -> np.ndarray:
        """Draw the round's cohort from the online pool (stale-filled)."""
        cohort = self.cohort_size
        pop = self.population
        replace = cohort > pop
        budget = self.max_draw_factor * cohort
        chosen: list[int] = []
        seen: set[int] = set()
        draws = 0
        while len(chosen) < cohort and draws < budget:
            k = min(max(2 * (cohort - len(chosen)), 16), budget - draws)
            cand = self.rng.integers(0, pop, size=k)
            draws += k
            mask = self.index.online(cand, round_idx)
            for c, ok in zip(cand.tolist(), mask.tolist()):
                if ok and (replace or c not in seen):
                    seen.add(c)
                    chosen.append(c)
                    if len(chosen) == cohort:
                        break
        online_n = len(chosen)
        if online_n < cohort:
            self._stale_fill(chosen, seen, cohort, replace)
        self.last_stats = {
            "online": online_n,
            "stale": cohort - online_n,
            "stale_fraction": (cohort - online_n) / cohort,
            "draws": draws,
            "online_pool": self.index.expected_online(round_idx),
        }
        return np.asarray(chosen, dtype=np.int64)

    def _stale_fill(self, chosen: list, seen: set, cohort: int,
                    replace: bool) -> None:
        """Fill the remainder with offline ("stale") clients.

        A few bounded RNG rounds keep the fill uniform; if duplicates keep
        colliding (tiny populations) a deterministic arithmetic scan from a
        random anchor finishes the job — this terminates for EVERY pool
        state, including all-clients-offline.
        """
        pop = self.population
        for _ in range(4):
            if len(chosen) >= cohort:
                return
            cand = self.rng.integers(0, pop, size=2 * (cohort - len(chosen)))
            for c in cand.tolist():
                if replace or c not in seen:
                    seen.add(c)
                    chosen.append(c)
                    if len(chosen) == cohort:
                        return
        anchor = int(self.rng.integers(0, pop))
        for i in range(pop):
            c = (anchor + i) % pop
            if replace or c not in seen:
                seen.add(c)
                chosen.append(c)
                if len(chosen) == cohort:
                    return
        while len(chosen) < cohort:        # cohort > population: wrap around
            chosen.append((anchor + len(chosen)) % pop)

    # -- checkpoint state --------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable config + RNG position (``sampler_state`` shape)."""
        return {"kind": "online",
                "population": self.population,
                "cohort_size": self.cohort_size,
                "seed": self.seed,
                "max_draw_factor": self.max_draw_factor,
                "rng": self.rng.bit_generator.state,
                "index": self.index.state_dict()}

    @classmethod
    def from_state(cls, state: dict) -> "OnlinePoolSampler":
        index = ArrivalIndex.from_state(state["index"])
        s = cls(index, state["cohort_size"], seed=state.get("seed", 1337),
                max_draw_factor=state.get("max_draw_factor", 64))
        if "rng" in state:
            s.rng.bit_generator.state = state["rng"]
        return s
