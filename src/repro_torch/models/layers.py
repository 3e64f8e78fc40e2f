"""Shared layer library — port of the dense-family part of
``repro/models/layers.py``.

Pure functions over tensors and explicit parameter dicts, in the
reference's layouts (``[b, s, heads, head_dim]`` for attention).  Attention
has the reference's three implementations (the ``attn_impl`` knob):

  * 'dense'   — materialized scores;
  * 'chunked' — softmax over query chunks, normalised per chunk;
  * 'pallas'  — the port's hand-written CUDA kernel K4
                (:func:`repro_torch.kernels.ops.flash_attention`), the
                plain version on CPU tensors.

``rms_norm(impl="pallas")`` likewise goes to K3.  The MoE layers wait for
the MoE slice (ROADMAP M15c).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref

__all__ = ["dense_init", "norm_init", "rms_norm", "rope",
           "causal_scores_mask", "gqa_attention", "decode_attention",
           "swiglu", "gelu_mlp"]


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype=torch.float32, *,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at ±2, times ``scale``
    (default ``1/sqrt(fan_in)``).

    Drawn on the CPU from ``gen`` with ``torch.randn`` and redrawn where
    ``|x| > 2``.  ``torch.nn.init.trunc_normal_`` is not used: its draws
    for one seeded generator differ between PyTorch releases (2.11 and 2.13
    give different SR weights), while ``randn``'s do not — so a seed gives
    the same weights on every machine and device.
    """
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen)
    bad = w.abs() > 2.0
    while bool(bad.any()):
        w[bad] = torch.randn(int(bad.sum()), generator=gen)
        bad = w.abs() > 2.0
    return (w * s).to(dtype)


def norm_init(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype)


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------
def rms_norm(x, scale, *, eps: float = 1e-6, impl: str = "xla"):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last dim, in f32,
    returned in ``x.dtype`` (bf16 residual streams stay bf16 under f32
    scales).  ``impl="pallas"`` runs the CUDA kernel K3 on a CUDA tensor;
    the reference's default ``"xla"`` is this plain expression."""
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        return kops.rmsnorm(x, scale, eps=eps)
    return ref.rmsnorm_ref(x, scale, eps=eps)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------
def _rope_angles(positions, head_dim: int, theta: float):
    """cos/sin of shape ``positions.shape + (head_dim // 2,)``.  The
    frequencies are ``exp(-i/hd * log(theta))`` in f32, with ``log(theta)``
    taken in f32, as the reference computes them."""
    dev = positions.device
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32,
                                       device=dev))
    freqs = torch.exp(-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                    device=dev) / head_dim * log_theta)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rope(x, positions, *, theta: float = 10_000.0):
    """Apply rotary embedding to the two halves of the head dim (not
    interleaved).  x: ``[..., seq, heads, head_dim]``; positions
    broadcastable to ``[..., seq]``."""
    hd = x.shape[-1]
    cos, sin = _rope_angles(positions, hd, theta)   # [..., s, hd/2]
    cos = cos[..., None, :]                          # [..., s, 1, hd/2]
    sin = sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def causal_scores_mask(scores, q_pos, k_pos):
    """Keep ``scores`` where ``q_pos >= k_pos``; elsewhere the lowest value
    of the scores' dtype."""
    mask = q_pos[..., :, None] >= k_pos[..., None, :]
    return torch.where(mask, scores, torch.finfo(scores.dtype).min)


def _dense_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """q: [b,s,Hq,hd]; k,v: [b,t,Hkv,hd] (GQA grouping internal)."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, s, hkv, g, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k) * scale
    if causal:
        q_pos = torch.arange(s, device=q.device) + q_offset
        k_pos = torch.arange(t, device=q.device)
        scores = causal_scores_mask(scores, q_pos, k_pos)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, hq, hd)


def _chunked_attention(q, k, v, *, causal: bool, q_chunk: int = 512,
                       q_offset: int = 0, repeat_kv: bool = False):
    """Softmax over query chunks of ``q_chunk`` rows, each normalised on its
    own (``max(l, 1e-30)``); memory O(s·q_chunk) instead of O(s²).

    ``repeat_kv`` materializes k/v per q-head first (g → 1), as the
    reference does for even tensor-parallel head sharding.
    """
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if repeat_kv and hkv != hq:
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
        v = torch.repeat_interleave(v, hq // hkv, dim=2)
        hkv = hq
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    q_chunk = min(q_chunk, s)
    n_chunks = (s + q_chunk - 1) // q_chunk
    pad = n_chunks * q_chunk - s
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    qs = q.reshape(b, n_chunks, q_chunk, hkv, g, hd)
    k_pos = torch.arange(t, device=q.device)
    outs = []
    for ci in range(n_chunks):
        scores = torch.einsum("bskgd,btkd->bkgst", qs[:, ci], k).float() \
            * scale
        if causal:
            q_pos = ci * q_chunk + torch.arange(q_chunk, device=q.device) \
                + q_offset
            scores = causal_scores_mask(scores, q_pos, k_pos)
        m = scores.amax(dim=-1, keepdim=True)
        p = torch.exp(scores - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkgst,btkd->bskgd", p.to(q.dtype), v)
        denom = l.permute(0, 3, 1, 2, 4)               # [b,s,k,g,1]
        outs.append(o / torch.clamp(denom, min=1e-30).to(o.dtype))
    out = torch.stack(outs, dim=1).reshape(b, n_chunks * q_chunk, hq, hd)
    return out[:, :s]


def gqa_attention(q, k, v, *, causal: bool = True, impl: str = "dense",
                  q_offset: int = 0, q_chunk: int = 512,
                  repeat_kv: bool = False):
    if impl == "dense":
        return _dense_attention(q, k, v, causal=causal, q_offset=q_offset)
    if impl == "chunked":
        return _chunked_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  q_chunk=q_chunk, repeat_kv=repeat_kv)
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal)
    raise ValueError(f"unknown attention impl {impl!r}")


def decode_attention(q, k_cache, v_cache, kv_len_mask):
    """Single-token decode: q [b,1,Hq,hd], caches [b,T,Hkv,hd], mask [T] or
    [b,T] marking valid cache slots (None: all valid)."""
    b, _, hq, hd = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k_cache).float() * scale
    if kv_len_mask is not None:
        m = kv_len_mask if kv_len_mask.ndim == 2 else kv_len_mask[None, :]
        scores = torch.where(m[:, None, None, :] > 0, scores,
                             torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs.to(q.dtype), v_cache)
    return out.reshape(b, 1, hq, hd)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    """GELU MLP; the tanh approximation, which is ``jax.nn.gelu``'s
    default in the reference.  A bias of ``None`` is left out (a config
    with ``use_bias=False``)."""
    z = x @ w_up
    if b_up is not None:
        z = z + b_up
    out = F.gelu(z, approximate="tanh") @ w_down
    return out if b_down is None else out + b_down
