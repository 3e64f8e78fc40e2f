"""Naturally-partitioned synthetic federated datasets — port of
``repro/data/federated.py``.

Client sizes and per-client class skew come from numpy exactly as in the
reference (same seed, same draws, bitwise-equal tables).  Batch *content*
is drawn from a numpy generator seeded per (client, batch), where the
reference uses ``jax.random.fold_in``: the values differ from the
reference's by design, the distribution is the same (standard-normal
features shifted by ``2·dir[y]``, labels from the client's Dirichlet class
mix; tokens ``(base // 4 + offset) % vocab_size`` with ``base`` uniform in
``[0, vocab_size)`` and the reference's per-client ``offset``, a
non-IID unigram skew).  IC and SR are labelled feature tasks, TG and MLM
token tasks (``models/papertasks.py``); the ``"lm"`` task feeds the LM
archs' federated training.

The engine takes any dataset whose ``gather_batches`` returns numpy, so the
parity tests hand it the reference's dataset object.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

__all__ = ["TaskSpec", "TASK_DISTRIBUTIONS", "FederatedDataset",
           "make_federated_dataset"]


@dataclass(frozen=True)
class TaskSpec:
    """Distributional + modality description of one FL task."""

    name: str
    kind: str                 # 'tokens' | 'image' | 'audio' | 'embeddings'
    n_clients: int
    batch_size: int           # paper A.1 batch sizes
    size_dist: str            # 'lognormal' | 'zipf'
    size_mu: float = 3.5      # lognormal mean of log(samples)
    size_sigma: float = 1.2
    zipf_a: float = 1.6
    size_min: int = 1
    size_max: int = 100_000
    n_classes: int = 0        # for labelled tasks
    dirichlet_alpha: float = 0.3


# The reference's table, verbatim (paper Fig. 2 shapes, A.1 batch sizes).
TASK_DISTRIBUTIONS: dict[str, TaskSpec] = {
    "tg": TaskSpec(name="tg", kind="tokens", n_clients=648, batch_size=4,
                   size_dist="lognormal", size_mu=5.0, size_sigma=1.4,
                   size_max=16_000, n_classes=0),
    "ic": TaskSpec(name="ic", kind="image", n_clients=13_771, batch_size=20,
                   size_dist="lognormal", size_mu=4.1, size_sigma=1.0,
                   size_max=10_000, n_classes=596),
    "sr": TaskSpec(name="sr", kind="audio", n_clients=2_168, batch_size=20,
                   size_dist="lognormal", size_mu=4.2, size_sigma=0.6,
                   size_max=4_000, n_classes=35),
    "mlm": TaskSpec(name="mlm", kind="tokens", n_clients=1_600_000, batch_size=20,
                    size_dist="zipf", zipf_a=1.35, size_max=60_000, n_classes=0),
    "lm": TaskSpec(name="lm", kind="tokens", n_clients=100_000, batch_size=8,
                   size_dist="lognormal", size_mu=4.5, size_sigma=1.3,
                   size_max=50_000, n_classes=0),
}

# Seed of the class-direction table (the reference uses jax.random.key(7)).
_DIRS_SEED = 7


class FederatedDataset:
    """Deterministic synthetic federated dataset.

    Client sizes are sampled once (seeded); example content is generated
    lazily per (client, batch), so memory stays O(1) per client until
    batches are materialized (paper §2.5).
    """

    def __init__(self, spec: TaskSpec, *, seed: int = 1337,
                 vocab_size: int = 32_000, seq_len: int = 128,
                 input_dim: int = 64):
        self.spec = spec
        self.seed = seed
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.input_dim = input_dim
        rng = np.random.default_rng(seed)
        n = spec.n_clients
        if spec.size_dist == "lognormal":
            sizes = rng.lognormal(mean=spec.size_mu, sigma=spec.size_sigma, size=n)
        elif spec.size_dist == "zipf":
            sizes = rng.zipf(a=spec.zipf_a, size=n).astype(np.float64)
        else:
            raise ValueError(spec.size_dist)
        sizes = np.clip(sizes, spec.size_min, spec.size_max).astype(np.int64)
        # Paper §5.1: exclude clients that cannot fill a single batch.
        sizes = np.maximum(sizes, spec.batch_size)
        self.sizes = sizes
        # Per-client class skew (labelled tasks): Dirichlet mixture weights.
        if spec.n_classes:
            self._class_logits = rng.dirichlet(
                [spec.dirichlet_alpha] * spec.n_classes, size=min(n, 65_536))
            self._dirs = np.random.default_rng(_DIRS_SEED).standard_normal(
                (spec.n_classes, input_dim), dtype=np.float32)
        else:
            self._class_logits = None
            self._dirs = None

    # -- population statistics (placement features) ------------------------
    @property
    def n_clients(self) -> int:
        return self.spec.n_clients

    def n_samples(self, cid: int) -> int:
        return int(self.sizes[cid % len(self.sizes)])

    def n_batches(self, cid: int) -> int:
        """x in the paper: samples // batch_size (at least 1)."""
        bs = self.spec.batch_size
        return max(1, int(self.n_samples(cid)) // bs)

    # -- deterministic content ---------------------------------------------
    def _token_offset(self, cids):
        """Host-side (int64-safe) client vocab offset for the tokens tasks,
        the reference's formula."""
        return (np.asarray(cids, dtype=np.int64) * 2_654_435_761) % max(
            self.vocab_size // 4, 1)

    def _batch(self, cid: int, batch_idx: int, bs: int, sl: int) -> dict:
        rng = np.random.default_rng(
            [self.seed, cid % (2 ** 31 - 1), batch_idx])
        if self.spec.kind == "tokens":
            # Client-specific unigram skew: a client-biased slice of the
            # vocab (non-IID token distribution).
            base = rng.integers(0, self.vocab_size, (bs, sl), dtype=np.int64)
            tokens = (base // 4 + self._token_offset(cid)) % self.vocab_size
            return {"tokens": tokens.astype(np.int32)}
        x = rng.standard_normal((bs, self.input_dim), dtype=np.float32)
        if self._class_logits is None:
            return {"x": x}
        probs = self._class_logits[cid % len(self._class_logits)]
        y = rng.choice(self.spec.n_classes, size=bs, p=probs)
        # Learnable task: shift inputs along a class-dependent direction.
        x = x + np.float32(2.0) * self._dirs[y]
        return {"x": x, "y": y.astype(np.int32)}

    def client_batch(self, cid: int, batch_idx: int, *, batch_size=None,
                     seq_len=None) -> dict:
        """Materialize one batch of this client's data."""
        out = self.gather_batches(np.asarray([cid]), np.asarray([batch_idx]),
                                  batch_size=batch_size, seq_len=seq_len)
        return {k: v[0] for k, v in out.items()}

    def gather_batches(self, cids, batch_idxs, *, batch_size=None,
                       seq_len=None) -> dict:
        """``{name: [N, ...]}`` numpy for N (client, batch) pairs."""
        cids = np.asarray(cids, dtype=np.int64)
        bis = np.asarray(batch_idxs, dtype=np.int64)
        if cids.shape != bis.shape or cids.ndim != 1:
            raise ValueError("cids and batch_idxs must be equal-length 1-D")
        bs = batch_size or self.spec.batch_size
        sl = seq_len or self.seq_len
        if cids.shape[0] == 0:
            sample = self._batch(0, 0, bs, sl)
            return {k: np.zeros((0,) + v.shape, v.dtype)
                    for k, v in sample.items()}
        rows = [self._batch(int(c), int(b), bs, sl)
                for c, b in zip(cids, bis)]
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def make_federated_dataset(task: str, *, seed: int = 1337, **overrides
                           ) -> FederatedDataset:
    spec = TASK_DISTRIBUTIONS[task]
    field_names = set(TaskSpec.__dataclass_fields__)
    spec_over = {k: v for k, v in overrides.items() if k in field_names}
    ds_over = {k: v for k, v in overrides.items() if k not in field_names}
    if spec_over:
        spec = replace(spec, **spec_over)
    return FederatedDataset(spec, seed=seed, **ds_over)
