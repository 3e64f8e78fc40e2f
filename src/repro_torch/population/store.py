"""Streaming client-metadata store: millions of clients, O(1) memory.

The open-world population registers clients by *count*, not by array: every
per-client attribute (region, availability phase, dataset size) is a pure
hash of the client id, so a 1M-client registry costs the same few hundred
bytes as a 1k-client one.  This is the property the streaming sampler
depends on — the registry is NEVER materialized, per round or ever
(tier-1 asserts construction peak memory is independent of population).

Attribute streams, all derived from splitmix64(cid ^ stream-tweaked seed):

* ``phase(cid)``   — uniform [0, 1): the client's availability threshold.
  The arrival index declares the client online at round t iff
  ``phase(cid) < online_fraction(region(cid), t)`` — a *nested threshold*,
  so raising the rate only ever ADDS clients (stable diurnal membership:
  the same devices come back every evening, which is what makes the
  device-batch cache meaningful under an open-world workload).
* ``region(cid)``  — categorical by cumulative region weights.
* ``n_samples(cid)`` — lognormal via Box–Muller on two more hash streams
  (the paper's Fig. 2 cloud of small clients), clipped and floored to one
  full batch like :class:`repro_torch.data.federated.FederatedDataset`.

:class:`PopulationDataset` grafts these statistics onto a small base
dataset whose per-batch *content* is already lazy (``fold_in`` keyed on
cid), giving the engine a dataset whose ``n_clients`` is the registered
population without any O(N) allocation.
"""

from __future__ import annotations

import numpy as np

from repro_torch.simcluster.profiles import REGIONS

__all__ = ["ClientMetadataStore", "PopulationDataset", "splitmix64"]

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_TWO64 = float(2 ** 64)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 in, uint64 out)."""
    with np.errstate(over="ignore"):
        z = (np.asarray(x, dtype=np.uint64) + _GOLDEN)
        z = (z ^ (z >> np.uint64(30))) * _MIX1
        z = (z ^ (z >> np.uint64(27))) * _MIX2
        return z ^ (z >> np.uint64(31))


class ClientMetadataStore:
    """Hash-derived per-client attributes for a registered population.

    All accessors take a scalar id or an int array and are O(1) in the
    population size; nothing here allocates per client.
    """

    def __init__(self, population: int, *, seed: int = 1337,
                 regions: dict | None = None, size_mu: float = 3.5,
                 size_sigma: float = 1.2, batch_size: int = 20,
                 size_min: int = 1, size_max: int = 100_000):
        if population <= 0:
            raise ValueError("population must be positive")
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.population = int(population)
        self.seed = int(seed)
        self.size_mu = float(size_mu)
        self.size_sigma = float(size_sigma)
        self.batch_size = int(batch_size)
        self.size_min = int(size_min)
        self.size_max = int(size_max)
        regions = regions if regions is not None else REGIONS
        self.region_names = tuple(regions)
        weights = np.asarray([regions[r].weight for r in self.region_names],
                             dtype=np.float64)
        if weights.sum() <= 0:
            raise ValueError("region weights must sum to a positive value")
        self._region_cum = np.cumsum(weights / weights.sum())

    # -- hash streams ------------------------------------------------------
    def _u01(self, cids, stream: int) -> np.ndarray:
        """Uniform [0, 1) stream ``stream`` for each cid (vectorized)."""
        x = np.asarray(cids, dtype=np.uint64)
        with np.errstate(over="ignore"):
            tweak = splitmix64(np.uint64((self.seed << 3) + stream))
            h = splitmix64(x ^ tweak)
        return h.astype(np.float64) / _TWO64

    # -- per-client attributes --------------------------------------------
    def phase(self, cids) -> np.ndarray:
        """Availability threshold in [0, 1) — the nested-threshold key."""
        return self._u01(cids, 0)

    def region_idx(self, cids) -> np.ndarray:
        """Index into :attr:`region_names` (categorical by weight)."""
        u = self._u01(cids, 1)
        return np.minimum(np.searchsorted(self._region_cum, u, side="right"),
                          len(self.region_names) - 1)

    def region(self, cid: int) -> str:
        return self.region_names[int(self.region_idx(cid))]

    def n_samples(self, cids):
        """Lognormal client dataset sizes via Box–Muller on hash uniforms."""
        u1 = np.maximum(self._u01(cids, 2), 1e-12)
        u2 = self._u01(cids, 3)
        z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
        samples = np.exp(self.size_mu + self.size_sigma * z)
        samples = np.clip(samples, self.size_min, self.size_max)
        # Paper §5.1: exclude clients that cannot fill a single batch.
        out = np.maximum(samples.astype(np.int64), self.batch_size)
        return out if np.ndim(cids) else int(out)

    def n_batches(self, cids):
        out = np.maximum(
            1, np.asarray(self.n_samples(cids), dtype=np.int64)
            // self.batch_size)
        return out if np.ndim(cids) else int(out)

    # -- checkpoint state --------------------------------------------------
    def state_dict(self) -> dict:
        return {"population": self.population, "seed": self.seed,
                "size_mu": self.size_mu, "size_sigma": self.size_sigma,
                "batch_size": self.batch_size, "size_min": self.size_min,
                "size_max": self.size_max,
                "region_names": list(self.region_names)}

    @classmethod
    def from_state(cls, state: dict, *, regions: dict | None = None
                   ) -> "ClientMetadataStore":
        regions = regions if regions is not None else REGIONS
        names = state.get("region_names", list(regions))
        picked = {n: regions[n] for n in names}
        return cls(state["population"], seed=state.get("seed", 1337),
                   regions=picked, size_mu=state.get("size_mu", 3.5),
                   size_sigma=state.get("size_sigma", 1.2),
                   batch_size=state.get("batch_size", 20),
                   size_min=state.get("size_min", 1),
                   size_max=state.get("size_max", 100_000))


class PopulationDataset:
    """A registered-population view over a small base dataset.

    ``n_clients`` / ``n_samples`` / ``n_batches`` come from the hash store
    (O(1) in the population); batch *content* delegates to the base
    dataset, whose generation is already lazy for any int64 cid.  The base
    never grows — a 1M-client view over a 256-client base allocates
    nothing new.
    """

    def __init__(self, base, store: ClientMetadataStore):
        if store.batch_size != base.spec.batch_size:
            raise ValueError(
                f"store batch_size {store.batch_size} != base dataset "
                f"batch_size {base.spec.batch_size}")
        self.base = base
        self.store = store

    @property
    def n_clients(self) -> int:
        return self.store.population

    @property
    def spec(self):
        return self.base.spec

    def n_samples(self, cid: int) -> int:
        return int(self.store.n_samples(int(cid)))

    def n_batches(self, cid: int) -> int:
        return int(self.store.n_batches(int(cid)))

    def client_batch(self, cid, batch_idx, *, batch_size=None, seq_len=None):
        return self.base.client_batch(cid, batch_idx, batch_size=batch_size,
                                      seq_len=seq_len)

    def gather_batches(self, cids, batch_idxs, *, batch_size=None,
                       seq_len=None):
        return self.base.gather_batches(cids, batch_idxs,
                                        batch_size=batch_size,
                                        seq_len=seq_len)

    def __getattr__(self, name):
        return getattr(self.base, name)
