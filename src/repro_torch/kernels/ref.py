"""Plain PyTorch versions of the port's kernels (the allclose targets).

Deliberately naive: these define correctness, the kernels define speed.
Each mirrors its counterpart in ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["fedavg_accum_ref", "dequant_merge_ref", "dequant_merge_flat_ref",
           "lane_weight", "rmsnorm_ref", "attention_ref",
           "flash_attention_bshd_ref"]


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


def rmsnorm_ref(x, scale, *, eps: float = 1e-6):
    """Per row of the last dim: ``x * rsqrt(mean(x^2) + eps) * scale``,
    computed in f32 and returned in ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def attention_ref(q, k, v, *, causal: bool = True):
    """q [b,hq,s,d]; k,v [b,hkv,t,d] — materialized-softmax GQA oracle.

    Query head ``h`` reads kv head ``h // (hq/hkv)``; the causal mask is
    ``key <= query`` counted from position 0 of both.  Computed in f32 and
    returned in ``q.dtype``."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, s, d)
    kf = k.float()
    vf = v.float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qf, kf) / math.sqrt(d)
    if causal:
        mask = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(t, device=q.device)[None, :])
        scores = scores.masked_fill(~mask, -math.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, vf)
    return out.reshape(b, hq, s, d).to(q.dtype)


def flash_attention_bshd_ref(q, k, v, *, causal: bool = True,
                             t_pad: int | None = None):
    """:func:`attention_ref` in the model layout (q ``[b,s,hq,d]``, k/v
    ``[b,t,hkv,d]``) with the keys ``t <= j < t_pad`` as zero vectors: the
    function the flash-attention kernel computes."""
    t = k.shape[1]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if t_pad is not None and t_pad != t:
        pad = (0, 0, 0, t_pad - t)
        kt = torch.nn.functional.pad(kt, pad)
        vt = torch.nn.functional.pad(vt, pad)
    out = attention_ref(q.transpose(1, 2), kt, vt, causal=causal)
    return out.transpose(1, 2)
