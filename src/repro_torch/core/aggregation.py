"""Hierarchical partial aggregation (paper §3.3, Eq. 1–2) — port of
``repro/core/aggregation.py``.

For *associative* strategies (FedAvg) a worker keeps a streaming weighted
average of trained client models::

    theta_{k+1}^w = (theta_k^w * N_k + theta_{k+1} * n_{k+1}) / N_{k+1}   (Eq. 1)
    N_{k+1}^w     = N_k^w + n_{k+1}                                       (Eq. 2)

so each worker uploads one model however many clients it trained.

Trees are ``{name: Tensor}`` dicts.  A partial's weight is a scalar, or a
``[L]`` vector when every leaf is lane-stacked ``[L, ...]`` (the round
step folds all its lanes at once).  Eq. 1 comes in the reference's two
variants, selected with ``impl``:

* ``"plain"`` — ``_accum_leaf_xla``: divides by ``max(N+n, 1e-20)`` in
  ``acc.dtype``, no zero-weight select;
* ``"kernel"`` — the hand-written K1 (:func:`repro_torch.kernels.ops
  .fedavg_accum`, the counterpart of ``impl="pallas"``): returns ``acc``
  where ``N+n == 0``.

They agree wherever ``N+n > 0``.  The non-associative FedMedian reduce
(:func:`median_leading`, :func:`fedmedian`) serves the gather path.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import lane_weight

__all__ = ["PartialAggregate", "partial_init", "partial_update",
           "partial_merge", "finalize", "fedavg_flat", "tree_weighted_mean",
           "fold_clients", "fedmedian", "median_leading", "AGG_IMPLS"]

AGG_IMPLS = ("kernel", "plain")


class PartialAggregate(NamedTuple):
    """(theta dict, weight) — a worker's running partial."""

    theta: Any
    weight: Any


def partial_init(like_tree: dict, *, lanes: int | None = None
                 ) -> PartialAggregate:
    """Zero partial with zero weight (identity of the monoid).  With
    ``lanes``, ``like_tree`` is lane-stacked and the weight is ``[lanes]``."""
    first = next(iter(like_tree.values()))
    shape = () if lanes is None else (lanes,)
    return PartialAggregate(
        {k: torch.zeros_like(v) for k, v in like_tree.items()},
        torch.zeros(shape, dtype=torch.float32, device=first.device))


def _accum_leaf_plain(acc, theta, n_old, n_new_total, n_k):
    # (acc*N + theta*n) / (N + n); guard the cold-start N==n==0 case.
    denom = lane_weight(torch.clamp(n_new_total, min=1e-20), acc).to(acc.dtype)
    return (acc * lane_weight(n_old, acc).to(acc.dtype)
            + theta * lane_weight(n_k, acc).to(acc.dtype)) / denom


def partial_update(partial: PartialAggregate, client_theta: dict, n_k,
                   *, impl: str = "kernel") -> PartialAggregate:
    """Eq. 1/2: fold one trained client model into the running partial.

    ``n_k`` may be a device tensor (0 for padded client slots); it is never
    read on the host.
    """
    acc, n_old = partial
    n_k = torch.as_tensor(n_k, dtype=torch.float32, device=n_old.device)
    n_new = n_old + n_k
    if impl == "kernel":
        new_acc = {k: kops.fedavg_accum(a, client_theta[k], n_old, n_k)
                   for k, a in acc.items()}
    elif impl == "plain":
        new_acc = {k: _accum_leaf_plain(a, client_theta[k], n_old, n_new, n_k)
                   for k, a in acc.items()}
    else:
        raise ValueError(f"agg impl must be one of {AGG_IMPLS}, got {impl!r}")
    return PartialAggregate(new_acc, n_new)


def partial_merge(p1: PartialAggregate, p2: PartialAggregate) -> PartialAggregate:
    """Associative merge of two partials (node-level combine)."""
    t1, n1 = p1
    t2, n2 = p2
    n = n1 + n2
    denom = torch.clamp(n, min=1e-20)
    theta = {k: (a * lane_weight(n1, a).to(a.dtype)
                 + t2[k] * lane_weight(n2, a).to(a.dtype))
             / lane_weight(denom, a).to(a.dtype)
             for k, a in t1.items()}
    return PartialAggregate(theta, n)


def finalize(partial: PartialAggregate) -> dict:
    """A finished partial already holds the weighted mean; return the tree."""
    return partial.theta


def tree_weighted_mean(stacked_tree: dict, weights) -> dict:
    """Weighted mean over the leading (lane/worker) dim of every leaf."""
    first = next(iter(stacked_tree.values()))
    w = torch.as_tensor(weights, dtype=torch.float32, device=first.device)
    denom = torch.clamp(w.sum(), min=1e-20)

    def leaf(x):
        wb = w.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
        return (x * wb).sum(dim=0) / denom.to(x.dtype)

    return {k: leaf(x) for k, x in stacked_tree.items()}


def fedavg_flat(client_trees: list, weights) -> dict:
    """One-shot FedAvg over a list of client trees (the oracle partial
    aggregation must match)."""
    stacked = {k: torch.stack([t[k] for t in client_trees])
               for k in client_trees[0]}
    return tree_weighted_mean(stacked, weights)


def median_leading(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the leading dim, as ``jnp.median(x,
    axis=0)``: the mean of the two middle values of the sorted column,
    ``(lo + hi) * 0.5`` (one rounding; the middle value itself for an odd
    count).  ``torch.median`` would return the lower middle value, and
    ``torch.quantile`` refuses inputs over 2^24 elements."""
    srt = torch.sort(x, dim=0).values
    n = x.shape[0]
    return (srt[(n - 1) // 2] + srt[n // 2]) * 0.5


def fedmedian(client_trees: list) -> dict:
    """Coordinate-wise median (non-associative robust aggregation — the
    paper's Table 7 strategy).  Requires the gather path: all client models
    at the server."""
    return {k: median_leading(torch.stack([t[k] for t in client_trees]))
            for k in client_trees[0]}


def fold_clients(global_params: dict, client_params_stacked: dict, n_samples,
                 *, impl: str = "kernel"):
    """Fold K stacked client models into one partial by Eq. 1, in order.

    client_params_stacked: leaves with leading dim K.  n_samples: (K,)
    weights (0 ⇒ padded slot).  Returns (weighted-mean tree, total weight).
    """
    first = next(iter(global_params.values()))
    ns = torch.as_tensor(n_samples, dtype=torch.float32, device=first.device)
    partial = partial_init(global_params)
    for i in range(ns.shape[0]):
        theta_i = {k: v[i] for k, v in client_params_stacked.items()}
        partial = partial_update(partial, theta_i, ns[i], impl=impl)
    return finalize(partial), partial.weight
