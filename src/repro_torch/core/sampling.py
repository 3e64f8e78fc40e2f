"""Cohort sampling (paper §3.1: placement is independent of selection).

Pollen runs *after* any client-selection algorithm; we provide the samplers
the paper references so the engine can compose them with any placement:

* uniform without replacement (default; with replacement when the population
  is too small, per §5.4),
* Power-of-Choice (Cho et al., 2020): oversample d clients, keep the m with
  the highest local loss,
* a FedCS-style deadline filter (Nishio & Yonetani, 2019): drop clients whose
  predicted round time exceeds a deadline — composes with the time model.

All samplers are deterministic given a seed (paper A.1 uses seed 1337).
"""

from __future__ import annotations

import numpy as np

__all__ = ["UniformSampler", "ZipfSampler", "PowerOfChoiceSampler",
           "DeadlineFilter", "sampler_state", "restore_sampler"]


class UniformSampler:
    def __init__(self, population: int, cohort_size: int, *, seed: int = 1337):
        if cohort_size <= 0:
            raise ValueError("cohort_size must be positive")
        self.population = population
        self.cohort_size = cohort_size
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.with_replacement = cohort_size > population

    def sample(self, round_idx: int) -> np.ndarray:
        """Sample client ids for a round (paper: 0.1% of population)."""
        return self.rng.choice(self.population, size=self.cohort_size,
                               replace=self.with_replacement)


class ZipfSampler:
    """Popularity-skewed sampling: client k is drawn with probability
    proportional to ``(k+1)**-a``.

    Real FL availability is heavy-tailed (the same devices come back round
    after round); uniform sampling never re-draws a client often enough for
    a hot-client cache to matter.  This sampler reproduces that recurrence
    structure — it is the benchmark workload for the engine's
    device-resident batch cache.
    """

    def __init__(self, population: int, cohort_size: int, *, a: float = 1.2,
                 seed: int = 1337):
        if cohort_size <= 0:
            raise ValueError("cohort_size must be positive")
        self.population = population
        self.cohort_size = cohort_size
        self.a = float(a)
        self.seed = seed
        ranks = np.arange(1, population + 1, dtype=np.float64)
        weights = ranks ** -float(a)
        self.p = weights / weights.sum()
        self.rng = np.random.default_rng(seed)
        self.with_replacement = cohort_size > population

    def sample(self, round_idx: int) -> np.ndarray:
        return self.rng.choice(self.population, size=self.cohort_size,
                               replace=self.with_replacement, p=self.p)


class PowerOfChoiceSampler:
    """Oversample ``d >= m`` candidates, pick the m largest by loss.

    The loss oracle is a *constructor* argument so ``sample(round_idx)``
    matches every other sampler's signature (the engine and the streaming
    OnlinePoolSampler share one protocol).  ``sample(t, client_loss)``
    still works for callers that supply a per-round oracle; with no oracle
    at all the sampler degenerates to a uniform pick of the first m
    candidates (the documented warm-up behaviour before any loss exists).
    """

    def __init__(self, population: int, cohort_size: int, *, d: int | None = None,
                 seed: int = 1337, client_loss=None):
        self.population = population
        self.cohort_size = cohort_size
        self.d = d or min(population, 2 * cohort_size)
        if self.d < cohort_size:
            raise ValueError("d must be >= cohort_size")
        self.seed = seed
        self.client_loss = client_loss
        self.rng = np.random.default_rng(seed)

    def sample(self, round_idx: int, client_loss=None) -> np.ndarray:
        oracle = client_loss if client_loss is not None else self.client_loss
        cand = self.rng.choice(self.population, size=self.d,
                               replace=self.d > self.population)
        if oracle is None:
            return cand[: self.cohort_size]
        losses = np.asarray([oracle(int(c)) for c in cand])
        top = np.argsort(-losses)[: self.cohort_size]
        return cand[top]


class DeadlineFilter:
    """FedCS-style: keep clients whose predicted time fits the deadline.

    ``predict(x)`` is typically the placement time model's g(x); clients with
    no prediction pass through (optimistic, like FedCS's first rounds).
    """

    def __init__(self, deadline: float):
        self.deadline = float(deadline)

    def filter(self, client_batches: np.ndarray, predict=None) -> np.ndarray:
        if predict is None:
            return np.ones(len(client_batches), dtype=bool)
        pred = np.atleast_1d(predict(np.asarray(client_batches, dtype=np.float64)))
        return pred <= self.deadline


# -- checkpointable sampler state --------------------------------------------
# A restored experiment must reproduce its workload: the sampler's full
# configuration (kind, population, cohort size, skew exponent, seed) plus the
# RNG stream position travel in the checkpoint's JSON metadata.  Note the
# stream position is exact for `pipeline_depth == 0` resumes; at depth >= 1
# the producer may have sampled in-flight rounds beyond the checkpointed one,
# so the restored stream is "ahead" by those draws — the engine therefore
# captures the state snapshot at prepare time, per round, and checkpoints the
# snapshot matching the restore point (see FederatedEngine.save_checkpoint).

def sampler_state(sampler) -> dict | None:
    """JSON-serializable config + RNG state, or None for unknown samplers.

    Covers every shipped sampler: uniform, zipf, power-of-choice (the loss
    oracle itself is a callable and cannot travel — a restored "poc"
    sampler starts with ``client_loss=None`` until the caller re-attaches
    one) and the population package's OnlinePoolSampler (whose state embeds
    the full arrival-index config: store params, traces, interventions).
    """
    if isinstance(sampler, ZipfSampler):
        state = {"kind": "zipf", "a": sampler.a}
    elif isinstance(sampler, UniformSampler):
        state = {"kind": "uniform"}
    elif isinstance(sampler, PowerOfChoiceSampler):
        state = {"kind": "poc", "d": int(sampler.d)}
    else:
        if hasattr(sampler, "state_dict"):          # OnlinePoolSampler et al.
            st = sampler.state_dict()
            return st if isinstance(st, dict) and "kind" in st else None
        return None
    state.update(population=int(sampler.population),
                 cohort_size=int(sampler.cohort_size),
                 seed=int(getattr(sampler, "seed", 1337)),
                 rng=sampler.rng.bit_generator.state)
    return state


def restore_sampler(state: dict):
    """Rebuild a sampler from :func:`sampler_state` output (exact config,
    RNG stream positioned where the snapshot was taken)."""
    kind = state["kind"]
    if kind == "zipf":
        s = ZipfSampler(state["population"], state["cohort_size"],
                        a=state.get("a", 1.2), seed=state.get("seed", 1337))
    elif kind == "uniform":
        s = UniformSampler(state["population"], state["cohort_size"],
                           seed=state.get("seed", 1337))
    elif kind == "poc":
        s = PowerOfChoiceSampler(state["population"], state["cohort_size"],
                                 d=state.get("d"),
                                 seed=state.get("seed", 1337))
    elif kind == "online":
        raise NotImplementedError(
            "the open-world OnlinePoolSampler is not ported yet "
            "(ROADMAP M17)")
    else:
        raise ValueError(f"unknown sampler kind {kind!r}")
    if "rng" in state:
        s.rng.bit_generator.state = state["rng"]
    return s
