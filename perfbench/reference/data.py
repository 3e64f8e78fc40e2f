"""The traffic of an FL cell, worked out again: which clients each round
draws, how many batches each holds, and the rows of each batch.

A frozen copy of the arithmetic of the program's synthetic federated
dataset and uniform and Zipf cohort samplers, kept here so that the
comparison never reads a table the program made.  The dataset is the
configuration's: the ``data`` group gives the task's parameters and the
``seed`` of its clients (their sizes, class mixes and rows), the same in
every run, so every run trains the same clients' work.  The run's seed
draws the cohorts; the traffic file gives the cohort's size and sampler.

``Traffic(seed, data)`` holds the client sizes; ``cohorts(rounds)`` the
ids each round draws; ``batch(cid, b)`` the rows of a client's batch
``b`` as numpy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Traffic", "local_steps"]

_TOKEN_MIX = 2_654_435_761


class Traffic:
    """Client sizes, cohorts and batches of one run (see the module
    docstring).  ``data`` keys: ``seed``, ``kind`` (``"features"`` or
    ``"tokens"``), ``n_clients``, ``batch_size``, ``size_mu``, ``size_sigma``,
    ``size_min``, ``size_max``; features add ``input_dim``, ``n_classes``,
    ``dirichlet_alpha``, ``dirs_seed``; tokens add ``vocab_size`` and
    ``seq_len``."""

    def __init__(self, seed: int, data: dict):
        self.seed = int(seed)                  # the run's: the cohorts
        self.data_seed = int(data["seed"])     # the dataset's
        self.data = data
        self.kind = data["kind"]
        self.bs = int(data["batch_size"])
        n = int(data["n_clients"])
        self.n_clients = n
        rng = np.random.default_rng(self.data_seed)
        sizes = rng.lognormal(mean=data["size_mu"], sigma=data["size_sigma"],
                              size=n)
        sizes = np.clip(sizes, data["size_min"], data["size_max"])
        self.sizes = np.maximum(sizes.astype(np.int64), self.bs)
        if self.kind == "features":
            k = int(data["n_classes"])
            self.class_p = rng.dirichlet([data["dirichlet_alpha"]] * k,
                                         size=min(n, 65_536))
            self.dirs = np.random.default_rng(data["dirs_seed"]) \
                .standard_normal((k, data["input_dim"]), dtype=np.float32)

    def n_batches(self, cid: int) -> int:
        return max(1, int(self.sizes[cid]) // self.bs)

    def weight(self, cid: int) -> int:
        """A client's FedAvg weight: its sample count."""
        return int(self.sizes[cid])

    def cohorts(self, rounds: int, traffic: dict) -> list[np.ndarray]:
        """The ids drawn in each of the first ``rounds`` rounds by the
        traffic's ``sampler``: ``uniform``, or ``zipf`` (client ``k`` drawn
        with probability proportional to ``(k + 1) ** -zipf_exponent``);
        without replacement unless the cohort outnumbers the clients."""
        n, cohort = self.n_clients, int(traffic["cohort"])
        p = None
        if traffic["sampler"] == "zipf":
            w = np.arange(1, n + 1, dtype=np.float64) ** -float(
                traffic["zipf_exponent"])
            p = w / w.sum()
        elif traffic["sampler"] != "uniform":
            raise ValueError(f"no cohort draw for {traffic['sampler']!r}")
        rng = np.random.default_rng(self.seed)
        return [rng.choice(n, size=cohort, replace=cohort > n, p=p)
                for _ in range(rounds)]

    def batch(self, cid: int, b: int) -> dict:
        rng = np.random.default_rng([self.data_seed, cid % (2 ** 31 - 1), b])
        if self.kind == "tokens":
            vocab = int(self.data["vocab_size"])
            base = rng.integers(0, vocab, (self.bs, int(self.data["seq_len"])),
                                dtype=np.int64)
            offset = (cid * _TOKEN_MIX) % max(vocab // 4, 1)
            return {"tokens": ((base // 4 + offset) % vocab).astype(np.int64)}
        x = rng.standard_normal((self.bs, int(self.data["input_dim"])),
                                dtype=np.float32)
        y = rng.choice(len(self.dirs), size=self.bs,
                       p=self.class_p[cid % len(self.class_p)])
        return {"x": x + np.float32(2.0) * self.dirs[y],
                "y": y.astype(np.int64)}


def local_steps(traffic: Traffic, cid: int, steps_cap: int | None) -> int:
    """The local steps a client trains: its batches, at most ``steps_cap``."""
    nb = traffic.n_batches(cid)
    return nb if steps_cap is None else min(nb, int(steps_cap))
