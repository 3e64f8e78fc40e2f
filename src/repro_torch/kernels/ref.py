"""Plain PyTorch versions of the port's kernels (the allclose targets).

Deliberately naive: these define correctness, the kernels define speed.
Each mirrors its counterpart in ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import torch

__all__ = ["fedavg_accum_ref", "lane_weight"]


def lane_weight(w, like: torch.Tensor) -> torch.Tensor:
    """``w`` as f32 on ``like``'s device, shaped to broadcast from the left.

    A scalar weight applies to the whole of ``like``; a ``[L]`` weight gives
    each slice ``like[l]`` of a lane-stacked leaf its own weight.
    """
    w = torch.as_tensor(w, dtype=torch.float32, device=like.device)
    if w.ndim > 1 or (w.ndim == 1 and (like.ndim == 0
                                       or w.shape[0] != like.shape[0])):
        raise ValueError(f"weight shape {tuple(w.shape)} does not match the "
                         f"lane dim of {tuple(like.shape)}")
    return w.reshape(w.shape + (1,) * (like.ndim - w.ndim))


def fedavg_accum_ref(acc, theta, n_old, n_k):
    """Eq. 1: (acc*N + theta*n)/(N+n); N+n == 0 -> acc unchanged.

    ``n_old``/``n_k``: scalars, or ``[L]`` per-lane weights for a
    lane-stacked ``acc`` of shape ``[L, ...]``.  Computed in f32, returned in
    ``acc.dtype``.
    """
    n_old = lane_weight(n_old, acc)
    n_k = lane_weight(n_k, acc)
    n_new = n_old + n_k
    denom = torch.where(n_new > 0, n_new, torch.ones_like(n_new))
    out = (acc.float() * n_old + theta.float() * n_k) / denom
    return torch.where(n_new > 0, out, acc.float()).to(acc.dtype)
