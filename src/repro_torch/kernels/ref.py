"""Plain PyTorch versions of the port's kernels (the allclose targets).

Deliberately naive: these define correctness, the kernels define speed.
Each mirrors its counterpart in ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import torch

__all__ = ["fedavg_accum_ref", "dequant_merge_ref", "dequant_merge_flat_ref",
           "lane_weight"]


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


def dequant_merge_ref(acc, q, g, scale, n_old, n_k):
    """Compressed-combine fold: dequantize an int8 delta payload against the
    global model g, then Eq. 1-blend it into the running accumulator —
    theta = g + q*scale; out = (acc*N + theta*n)/(N+n); N+n == 0 -> acc.
    ``scale`` is a scalar or a tensor that broadcasts against ``q``."""
    n_old = torch.as_tensor(n_old, dtype=torch.float32, device=acc.device)
    n_k = torch.as_tensor(n_k, dtype=torch.float32, device=acc.device)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=acc.device)
    n_new = n_old + n_k
    denom = torch.where(n_new > 0, n_new, torch.ones_like(n_new))
    theta = g.float() + q.float() * scale
    out = (acc.float() * n_old + theta * n_k) / denom
    return torch.where(n_new > 0, out, acc.float()).to(acc.dtype)


def dequant_merge_flat_ref(acc, q, g, scales, offsets, n_old, n_k):
    """:func:`dequant_merge_ref` over a flat buffer of several leaves: leaf
    ``i`` spans ``offsets[i]:offsets[i+1]`` of ``acc``/``q``/``g`` (``[N]``)
    and dequantizes with ``scales[i]``."""
    sizes = torch.diff(torch.as_tensor(offsets, dtype=torch.int64,
                                       device=acc.device))
    per_elem = torch.repeat_interleave(scales.to(acc.device), sizes,
                                       output_size=acc.numel())
    return dequant_merge_ref(acc, q, g, per_elem, n_old, n_k)
