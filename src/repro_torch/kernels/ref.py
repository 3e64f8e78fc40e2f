"""Plain PyTorch versions of the port's kernels (the allclose targets).

Deliberately naive: these define correctness, the kernels define speed.
Each mirrors its counterpart in ``repro/kernels/ref.py``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["fedavg_accum_ref", "dequant_merge_ref", "dequant_merge_flat_ref",
           "lane_weight", "rmsnorm_ref", "attention_ref",
           "flash_attention_bshd_ref", "ssd_ref", "ssd_chunks_ref"]


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


def ssd_ref(x, dt, A_log, B, C, D):
    """Token-recurrent SSD oracle in the kernel's ``[b, h, s, p]`` layout
    (dt ``[b, h, s]``, B/C ``[b, g, s, n]``): per token, ``state =
    exp(dt A) state + dt x (x) B`` and ``y = state . C + D x``, with ``A =
    -exp(A_log)`` and head ``h`` reading group ``h // (H/G)``.  Computed in
    f32 and returned in ``x.dtype``."""
    b, h, s, p = x.shape
    g, n = B.shape[1], B.shape[3]
    hpg = h // g
    A = -torch.exp(A_log.float())
    Bh = torch.repeat_interleave(B, hpg, dim=1).float()    # [b,h,s,n]
    Ch = torch.repeat_interleave(C, hpg, dim=1).float()
    xf, dtf = x.float(), dt.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        a = torch.exp(dtf[:, :, t] * A)                    # [b,h]
        state = state * a[..., None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dtf[:, :, t], xf[:, :, t], Bh[:, :, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, :, t]))
    y = torch.stack(ys, dim=2)
    y = y + xf * D.float()[None, :, None, None]
    return y.to(x.dtype)


def ssd_chunks_ref(x, dt, A_log, B, C, D, *, chunk: int):
    """The chunked SSD in the model layout (x ``[b, s, h, p]``, dt ``[b, s,
    h]``, B/C ``[b, s, g, n]``), in the TPU kernel's own order
    (``repro/kernels/ssd.py:38-80``): for every (batch, head) at once, a
    loop over chunks of ``chunk`` rows carrying a ``[p, n]`` f32 state --

        la = cumsum(dt A);  y = ((C B^T) * L)(dt x) + exp(la) (C state^T)
        state = exp(la_Q) state + (exp(la_Q - la) dt x)^T B;  y += D x

    -- the function the CUDA kernel K5 computes.  A last chunk shorter
    than ``chunk`` is the zero padding of the TPU wrapper (zero rows change
    nothing).  Returns ``(y [b, s, h, p]`` in ``x.dtype``, the final state
    ``[b, h, p, n]`` f32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = h // g
    A = -torch.exp(A_log.float())
    Df = D.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, min(t0 + chunk, s))
        xc = x[:, sl].float()                              # [b,q,h,p]
        dtc = dt[:, sl].float()                            # [b,q,h]
        Bc = torch.repeat_interleave(B[:, sl].float(), hpg, dim=2)
        Cc = torch.repeat_interleave(C[:, sl].float(), hpg, dim=2)
        q = xc.shape[1]
        la = torch.cumsum(dtc * A, dim=1)                  # [b,q,h]
        xbar = xc * dtc[..., None]
        cb = torch.einsum("bihn,bjhn->bhij", Cc, Bc)       # [b,h,q,q]
        lah = la.transpose(1, 2)                           # [b,h,q]
        mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                     device=x.device))
        ldiff = torch.where(mask, lah[..., :, None] - lah[..., None, :], 0.0)
        decay = torch.where(mask, torch.exp(ldiff), 0.0)
        y = torch.einsum("bhij,bjhp->bihp", cb * decay, xbar)
        y = y + torch.exp(la)[..., None] * torch.einsum(
            "bihn,bhpn->bihp", Cc, state)
        la_last = la[:, -1]                                # [b,h]
        sdec = torch.exp(la_last[:, None, :] - la)         # [b,q,h]
        state = state * torch.exp(la_last)[..., None, None] + torch.einsum(
            "bjhp,bjhn->bhpn", sdec[..., None] * xbar, Bc)
        ys.append(y + xc * Df[None, None, :, None])
    return torch.cat(ys, dim=1).to(x.dtype), state
