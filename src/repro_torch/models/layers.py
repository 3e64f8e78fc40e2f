"""Shared layer library — port of ``repro/models/layers.py``.

Pure functions over tensors and explicit parameter dicts, in the
reference's layouts (``[b, s, heads, head_dim]`` for attention).  Attention
has the reference's three implementations (the ``attn_impl`` knob):

  * 'dense'   — materialized scores;
  * 'chunked' — softmax over query chunks, normalised per chunk;
  * 'pallas'  — the port's hand-written CUDA kernel K4
                (:func:`repro_torch.kernels.ops.flash_attention`), the
                plain version on CPU tensors.

``rms_norm(impl="pallas")`` likewise goes to K3.  The MoE layers
(``moe_layer``, ``moe_layer_3d``, ``_moe_dispatch``) have the reference's two
dispatch implementations (the ``moe_impl`` knob), 'einsum' and 'scatter';
no Pallas kernel is on their path in the reference, so they are plain
PyTorch here too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ref

__all__ = ["dense_init", "norm_init", "rms_norm", "rope",
           "causal_scores_mask", "gqa_attention", "decode_attention",
           "swiglu", "gelu_mlp", "moe_layer", "moe_layer_3d"]


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

    Each redraw fills the out-of-range positions in index order, and only
    the positions just redrawn are tested again: the same draws, in the
    same order, as testing the whole tensor after each redraw, at a third
    of the time (the serve paths draw billions of weights this way).
    """
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen)
    flat = w.view(-1)
    redraw = ((flat > 2.0) | (flat < -2.0)).nonzero().squeeze(1)
    while redraw.numel():
        vals = torch.randn(redraw.numel(), generator=gen)
        flat[redraw] = vals
        redraw = redraw[vals.abs() > 2.0]
    return w.mul_(s).to(dtype)


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
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """The ``head_dim // 2`` rotary frequencies ``exp(-i/hd * log(theta))``
    in f32, with ``log(theta)`` taken in f32, as the reference computes
    them.  The library's ``exp`` may round a frequency to the neighbouring
    f32 value of the reference's (one ulp)."""
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32,
                                       device=device))
    return torch.exp(-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim * log_theta)


def rope_angles(positions, freqs: torch.Tensor) -> torch.Tensor:
    """Angles ``positions.shape + freqs.shape``: position times frequency,
    one f32 rounding."""
    return positions.float()[..., None] * freqs


def _rope_angles(positions, head_dim: int, theta: float):
    """cos/sin of shape ``positions.shape + (head_dim // 2,)``."""
    ang = rope_angles(positions, rope_freqs(head_dim, theta,
                                            positions.device))
    return torch.cos(ang), torch.sin(ang)


def rope_rotate(x, cos, sin):
    """Rotate the two halves of the head dim (not interleaved) by the
    angles whose ``cos``/``sin`` are ``[..., s, hd/2]``; f32 math, output
    in ``x.dtype``."""
    cos = cos[..., None, :]                          # [..., s, 1, hd/2]
    sin = sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope(x, positions, *, theta: float = 10_000.0):
    """Apply rotary embedding to the two halves of the head dim (not
    interleaved).  x: ``[..., seq, heads, head_dim]``; positions
    broadcastable to ``[..., seq]``."""
    return rope_rotate(x, *_rope_angles(positions, x.shape[-1], theta))


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


# --------------------------------------------------------------------------
# Mixture of Experts
# --------------------------------------------------------------------------
def moe_layer(x, router_w, moe_gate, moe_up, moe_down, *, top_k: int,
              capacity_factor: float = 1.25, impl: str = "einsum",
              ep_shard=None, token_chunk: int = 0, remat: bool = False):
    """Top-k routed MoE over flattened tokens ``x [T, D]`` (see
    :func:`_moe_dispatch`).

    ``token_chunk`` > 0 routes blocks of that many tokens one after the
    other (the tail zero-padded), so the capacity buffers scale with the
    block: capacity ``C = cf·k·Tc/E`` per block.  The aux term is the mean
    over blocks.  ``remat`` recomputes each block in backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
    """
    T, D = x.shape
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, impl=impl,
              ep_shard=ep_shard)
    if not token_chunk or T <= token_chunk:
        return _moe_dispatch(x, router_w, moe_gate, moe_up, moe_down, **kw)
    pad = (-T) % token_chunk
    if pad:
        x = torch.cat([x, x.new_zeros(pad, D)])
    outs, aux = _chunked(
        lambda xc: _moe_dispatch(xc, router_w, moe_gate, moe_up, moe_down,
                                 **kw),
        x.split(token_chunk), remat)
    return torch.cat(outs)[:T], aux


def moe_layer_3d(x3, router_w, moe_gate, moe_up, moe_down, *, top_k: int,
                 capacity_factor: float = 1.25, impl: str = "einsum",
                 ep_shard=None, seq_chunk: int = 0, remat: bool = False):
    """Batched MoE over ``x3 [b, s, D]``, dispatched in blocks of
    ``seq_chunk`` positions along ``s`` (the batch kept whole; the tail
    zero-padded), each block's ``b·seq_chunk`` tokens routed together.
    The aux term is the mean over blocks."""
    b, s, D = x3.shape
    kw = dict(top_k=top_k, capacity_factor=capacity_factor, impl=impl,
              ep_shard=ep_shard)
    if not seq_chunk or s <= seq_chunk:
        out, aux = _moe_dispatch(x3.reshape(b * s, D), router_w, moe_gate,
                                 moe_up, moe_down, **kw)
        return out.reshape(b, s, D), aux
    pad = (-s) % seq_chunk
    if pad:
        x3 = F.pad(x3, (0, 0, 0, pad))

    def block(xc):                                # xc [b, sc, D]
        out, aux = _moe_dispatch(xc.reshape(b * seq_chunk, D), router_w,
                                 moe_gate, moe_up, moe_down, **kw)
        return out.reshape(b, seq_chunk, D), aux

    outs, aux = _chunked(block, x3.split(seq_chunk, dim=1), remat)
    return torch.cat(outs, dim=1)[:, :s], aux


def _chunked(fn, chunks, remat: bool):
    """``fn`` over ``chunks`` in order: (outputs, mean aux), the aux terms
    summed from 0 in chunk order as the reference's scan carries them."""
    outs = []
    aux = torch.zeros((), dtype=torch.float32, device=chunks[0].device)
    for xc in chunks:
        out, a = (checkpoint(fn, xc, use_reentrant=False) if remat
                  else fn(xc))
        outs.append(out)
        aux = aux + a
    return outs, aux / len(chunks)


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest values per row, largest first, and
    among equal values the lower index first.  ``torch.topk`` promises no
    order for ties on CUDA; a stable descending sort keeps equal values in
    index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _moe_dispatch(x, router_w, moe_gate, moe_up, moe_down, *, top_k: int,
                  capacity_factor: float = 1.25, impl: str = "einsum",
                  ep_shard=None):
    """Top-k routed MoE over flattened tokens, with capacity dropping.

    x ``[T, D]``; router_w ``[D, E]``; moe_gate/up ``[E, D, F]``; moe_down
    ``[E, F, D]``.  Router logits in f32, softmax, the top-k gates
    renormalised; each expert takes at most ``C = max(1, int(cf·k·T/E))``
    (token, k) slots, first come first served in (token, k) order, and the
    slots beyond are dropped (they add nothing to the output).

    impl='einsum'  — one-hot dispatch and combine products over ``[T, k, E,
    C]`` (the reference's baseline);
    impl='scatter' — the tokens placed in ``[E, C, D]`` capacity buffers
    (the reference scatter-adds them; the port gathers them, the same
    values), batched expert products, a gather back in which dropped
    slots read a zero row.

    Returns ``(out [T, D] in x.dtype, aux f32)``, aux the Switch
    load-balance term ``E · Σ_e density_e · mean_t(probs_e)``, density from
    each token's first choice.
    """
    if ep_shard is not None:
        raise NotImplementedError(
            "ep_shard: expert-parallel buffer sharding needs a mesh of "
            "several cards; the port runs MoE on one card, where it is not "
            "applicable (docs/PORT.md)")
    T, D = x.shape
    E = router_w.shape[-1]
    logits = (x @ router_w).float()                         # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, top_k)              # [T, k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)          # renormalize
    C = max(1, int(capacity_factor * top_k * T / E))

    # position of each (token, k) within its expert's capacity buffer: a
    # running count down the flat [T*k, E] one-hot, taken along the rows of
    # its contiguous transpose (CUDA scans a column-wise cumsum with one
    # thread a column: 16 ms a layer at 65,536 x 40).
    flat_onehot = F.one_hot(gate_idx.reshape(T * top_k), E)  # [T*k, E]
    counts = torch.cumsum(flat_onehot.T.contiguous(), dim=1).T
    pos_in_expert = counts * flat_onehot - 1

    if impl == "einsum":
        # One-hot over C of each slot's position: -1 (not this expert) and
        # positions >= C (dropped) match no column, so their rows are zero
        # (``jax.nn.one_hot(-1, C)`` in the reference).
        cap_oh = (pos_in_expert.reshape(T, top_k, E, 1)
                  == torch.arange(C, device=x.device)).to(x.dtype)
        combine = cap_oh * gate_vals[..., None, None].to(x.dtype)
        expert_in = torch.einsum("tkec,td->ecd", cap_oh, x)     # [E, C, D]
        h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, moe_gate))
        h = h * torch.einsum("ecd,edf->ecf", expert_in, moe_up)
        expert_out = torch.einsum("ecf,efd->ecd", h, moe_down)  # [E, C, D]
        out = torch.einsum("tkec,ecd->td", combine, expert_out)
    elif impl == "scatter":
        flat_expert = gate_idx.reshape(-1)                       # [T*k]
        flat_pos = pos_in_expert.gather(1, flat_expert[:, None])[:, 0]
        ok = (flat_pos >= 0) & (flat_pos < C)
        slot = torch.where(ok, flat_expert * C + flat_pos, E * C)
        # The reference scatter-adds the tokens into [E*C + 1, D], every
        # dropped slot onto the overflow row E*C.  Each kept slot has a row
        # of its own, so that is a gather: ``src`` maps each buffer row to
        # the token of the slot that lands there, or to a zero row (T).  It
        # is built with unique indices (each dropped slot parked on a row
        # of its own past the buffer): on the card a deterministic scatter
        # serialises repeated indices, 15 ms a layer at granite's prefill.
        n = T * top_k
        arange = torch.arange(n, device=x.device)
        dest = torch.where(ok, slot, E * C + arange)
        src = torch.full((E * C + n,), T, dtype=torch.long, device=x.device)
        src.index_copy_(0, dest, arange // top_k)
        x_pad = torch.cat([x, x.new_zeros(1, D)])
        expert_in = x_pad[src[:E * C]].reshape(E, C, D)
        h = F.silu(torch.bmm(expert_in, moe_gate))
        h = h * torch.bmm(expert_in, moe_up)
        expert_out = torch.bmm(h, moe_down).reshape(E * C, D)
        expert_out = torch.cat([expert_out, x.new_zeros(1, D)])
        gathered = expert_out[slot]                              # [T*k, D]
        out = (gathered.reshape(T, top_k, D)
               * gate_vals[..., None].to(x.dtype)).sum(dim=1)
    else:
        raise ValueError(f"unknown moe impl {impl!r}")

    # Switch-style load-balance ingredients.
    density = F.one_hot(gate_idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(density * probs.mean(0))
    return out.to(x.dtype), aux
