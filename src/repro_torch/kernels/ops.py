"""Public wrappers around the port's kernels.

They adapt any-shape leaves to the kernel layouts.  A tensor on the CPU
takes the plain version (``ref``); a CUDA tensor launches the hand-written
kernel or raises — there is no fallback.

    fedavg_accum(acc, theta, n_old, n_k)          — any-shape leaf, or a
                                                    lane-stacked [L, ...]
                                                    leaf with [L] weights
    dequant_merge(acc, q, g, scale, n_old, n_k)   — any-shape leaf
    dequant_merge_flat(acc, q, g, scales, offsets, n_old, n_k)
                                                  — a flat [N] buffer of
                                                    several leaves, one
                                                    scale per leaf
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dequant_merge as _dm
from repro_torch.kernels import fedavg_accum as _fa
from repro_torch.kernels import ref

__all__ = ["fedavg_accum", "dequant_merge", "dequant_merge_flat",
           "launch_counts", "reset_launch_counts"]


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"fedavg_accum": _fa.LAUNCHES, "dequant_merge": _dm.LAUNCHES}


def reset_launch_counts() -> None:
    _fa.LAUNCHES = 0
    _dm.LAUNCHES = 0


def _lane_vector(w, lanes: int, device) -> torch.Tensor:
    w = torch.as_tensor(w, dtype=torch.float32, device=device)
    if w.ndim == 0:
        return w.reshape(1).expand(lanes).contiguous()
    return w.reshape(-1).contiguous()


def fedavg_accum(acc, theta, n_old, n_k):
    """Streaming Eq. 1 update on one leaf.

    ``n_old``/``n_k`` are scalars (the whole leaf is one partial, as in
    ``repro.kernels.ops.fedavg_accum``) or ``[L]`` tensors (``acc`` is
    ``[L, ...]`` and lane ``l`` folds with its own weights).  ``theta`` is
    cast to ``acc.dtype`` first, as the reference wrapper does.
    """
    theta = theta.to(acc.dtype)
    if acc.device.type == "cpu":
        return ref.fedavg_accum_ref(acc, theta, n_old, n_k)
    if acc.device.type != "cuda":
        raise ValueError(f"no fedavg_accum kernel for device {acc.device}")
    per_lane = any(torch.is_tensor(w) and w.ndim == 1 for w in (n_old, n_k))
    lanes = acc.shape[0] if per_lane else 1
    flat_a = acc.reshape(lanes, -1).contiguous()
    flat_t = theta.reshape(lanes, -1).contiguous()
    out = _fa.fedavg_accum_lanes(flat_a, flat_t,
                                 _lane_vector(n_old, lanes, acc.device),
                                 _lane_vector(n_k, lanes, acc.device))
    return out.reshape(acc.shape)


def dequant_merge_flat(acc, q, g, scales, offsets, n_old, n_k):
    """The compressed combine's fold over a flat multi-leaf buffer: leaf
    ``i`` spans ``offsets[i]:offsets[i+1]`` of ``acc``/``q``/``g`` and
    dequantizes with ``scales[i]``.  ``acc``/``g`` f32, ``q`` int8; the
    weights are scalars or one-element tensors, read on the device."""
    if acc.device.type == "cpu":
        return ref.dequant_merge_flat_ref(acc, q, g, scales, offsets,
                                          n_old, n_k)
    if acc.device.type != "cuda":
        raise ValueError(f"no dequant_merge kernel for device {acc.device}")
    dev = acc.device
    return _dm.dequant_merge_flat(
        acc.contiguous(), q.contiguous(), g.contiguous(),
        torch.as_tensor(scales, dtype=torch.float32, device=dev).contiguous(),
        torch.as_tensor(offsets, dtype=torch.int64, device=dev).contiguous(),
        _lane_vector(n_old, 1, dev), _lane_vector(n_k, 1, dev))


def dequant_merge(acc, q, g, scale, n_old, n_k):
    """Fused compressed-combine fold on one f32 leaf of any shape, as
    ``repro.kernels.ops.dequant_merge``: ``theta = g + q*scale``, then the
    Eq. 1 blend of ``theta`` into ``acc`` (``acc`` where ``N+n == 0``)."""
    g = g.to(acc.dtype)
    if acc.device.type == "cpu":
        return ref.dequant_merge_ref(acc, q, g, scale, n_old, n_k)
    out = dequant_merge_flat(acc.reshape(-1), q.reshape(-1), g.reshape(-1),
                             _lane_vector(scale, 1, acc.device),
                             [0, acc.numel()], n_old, n_k)
    return out.reshape(acc.shape)
