"""Mamba-2 SSD (state-space duality) sequence mixer — port of
``repro/models/ssd.py``.

Three execution paths, numerically interchangeable (tested against each
other and against the reference):

* :func:`ssd_recurrent` — token-by-token linear recurrence (the oracle for
  tiny shapes);
* :func:`ssd_chunked`   — the chunked SSD algorithm (Dao & Gu 2024):
  masked-decay matmuls inside chunks of Q tokens, a loop over chunks for
  the carried states;
* ``impl='pallas'``     — the port's hand-written CUDA kernel K5
  (:func:`repro_torch.kernels.ops.ssd`; its plain version on CPU tensors),
  which also returns the final state, so prefill needs no second pass.

Layout conventions (b=batch, s=seq, h=heads, p=head_dim, g=B/C groups,
n=state dim), as the reference's:

    x  [b, s, h, p]     dt [b, s, h]      A_log [h]  (A = -exp(A_log) < 0)
    B  [b, s, g, n]     C  [b, s, g, n]   D [h]
    state [b, h, p, n]

:func:`mamba2_mixer` adds the in/out projections, the causal depthwise conv
over (x, B, C), the dt softplus and the gated RMSNorm;
:func:`mamba2_decode_step` is the one-token path that carries
``(conv, ssm)`` states.  Plain functions on tensors, in the reference's
dtypes: f32 math where it computes in f32, ``x.dtype`` elsewhere.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device

__all__ = [
    "ssd_recurrent", "ssd_chunked", "ssd_decode_step",
    "mamba2_mixer", "mamba2_init_cache", "mamba2_decode_step", "MambaCache",
    "mamba_param_shapes", "HeadSplit",
]


def _heads_to_groups(h: int, g: int) -> int:
    if h % g:
        raise ValueError(f"heads {h} not divisible by groups {g}")
    return h // g


def _softplus(x):
    """``jax.nn.softplus``'s formula, ``max(x, 0) + log1p(exp(-|x|))``."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _gated_norm(y, z, scale, dtype, split=None):
    """Mamba-2's gated RMSNorm: ``norm(y * silu(z)) * scale``, the product
    in ``y``'s dtype, the norm in f32, the result in ``dtype``.  With
    ``split`` the channels are a rank's share of ``d_inner``: the mean
    square is over all of them (the ranks' sums of squares summed by
    ``split.total``), the scale the rank's slice."""
    yf = (y * F.silu(z)).float()
    if split is None:
        var = yf.square().mean(dim=-1, keepdim=True)
    else:
        var = split.total(yf.square().sum(dim=-1, keepdim=True)) \
            / (yf.shape[-1] * split.m)
        scale = scale.narrow(0, split.r * yf.shape[-1], yf.shape[-1])
    return (yf * torch.rsqrt(var + 1e-6) * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# core SSD
# ---------------------------------------------------------------------------
def ssd_recurrent(x, dt, A_log, B, C, D, *, state=None):
    """Token-by-token oracle: ``y[t] = C[t]·h[t] + D*x[t]``,
    ``h[t] = exp(dt[t]*A)*h[t-1] + dt[t]*x[t]⊗B[t]``.  Returns
    ``(y, final_state)``."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = _heads_to_groups(h, g)
    A = -torch.exp(A_log.float())                              # [h]
    if state is None:
        state = torch.zeros((b, h, p, n), dtype=torch.float32,
                            device=x.device)
    Bh = torch.repeat_interleave(B, hpg, dim=2)                # [b,s,h,n]
    Ch = torch.repeat_interleave(C, hpg, dim=2)
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()                                 # [b,h]
        a = torch.exp(dtt * A)
        state = (state * a[..., None, None]
                 + dtt[..., None, None]
                 * torch.einsum("bhp,bhn->bhpn", x[:, t].float(),
                                Bh[:, t].float()))
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t].float()))
    y = torch.stack(ys, dim=1)                                 # [b,s,h,p]
    y = y + x.float() * D.float()[None, None, :, None]
    return y.to(x.dtype), state


def ssd_chunked(x, dt, A_log, B, C, D, *, chunk: int = 128, state=None,
                return_state: bool = False):
    """Chunked SSD (Mamba-2 algorithm; 'state-space duality').

    Linear in ``s`` for a fixed chunk Q: the intra-chunk term is a masked
    decay matmul over ``[b, nc, h, Q, Q]``; the inter-chunk term a loop over
    the ``s/Q`` chunk states ``[b, h, p, n]``.  The sequence is zero-padded
    to a multiple of Q, as the reference does.
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = _heads_to_groups(h, g)
    Q = min(chunk, s)
    pad = (-s) % Q
    if pad:
        def zf(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
        x, dt, B, C = zf(x), zf(dt), zf(B), zf(C)
    s_pad = s + pad
    nc = s_pad // Q

    A = -torch.exp(A_log.float())                              # [h]
    dtf = dt.float().reshape(b, nc, Q, h)
    xf = x.float().reshape(b, nc, Q, h, p)
    Bf = B.float().reshape(b, nc, Q, g, n)
    Cf = C.float().reshape(b, nc, Q, g, n)

    xbar = xf * dtf[..., None]                                 # dt-weighted
    la = torch.cumsum(dtf * A, dim=2)                          # [b,nc,Q,h]
    la_last = la[:, :, -1]                                     # [b,nc,h]

    # ---- intra-chunk: masked-decay "attention" ----------------------------
    Bh = torch.repeat_interleave(Bf, hpg, dim=3)               # [b,nc,Q,h,n]
    Ch = torch.repeat_interleave(Cf, hpg, dim=3)
    cb = torch.einsum("bcihn,bcjhn->bchij", Ch, Bh)            # [b,nc,h,Q,Q]
    lah = la.transpose(2, 3)                                   # [b,nc,h,Q]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ldec = torch.where(mask, lah[..., :, None] - lah[..., None, :], 0.0)
    decay = torch.where(mask, torch.exp(ldec), 0.0)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", cb * decay, xbar)

    # ---- chunk states + inter-chunk recurrence ----------------------------
    # S_c = sum_j exp(la_last - la_j) * B_j ⊗ xbar_j  -> [b,nc,h,p,n]
    sdec = torch.exp(la_last[:, :, None, :] - la)              # [b,nc,Q,h]
    S_c = torch.einsum("bcjhn,bcjhp->bchpn", Bh, sdec[..., None] * xbar)
    chunk_decay = torch.exp(la_last)                           # [b,nc,h]

    if state is None:
        state = torch.zeros((b, h, p, n), dtype=torch.float32,
                            device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + S_c[:, c]
    prev_states = torch.stack(prev, dim=1)                     # [b,nc,h,p,n]

    # ---- inter-chunk output: y_inter[i] = exp(la_i) * C_i · H_{c-1} -------
    y_inter = torch.einsum("bcihn,bchpn->bcihp", Ch, prev_states) \
        * torch.exp(la)[..., None]
    y = (y_intra + y_inter).reshape(b, s_pad, h, p)[:, :s]
    y = y + x.float().reshape(b, s_pad, h, p)[:, :s] \
        * D.float()[None, None, :, None]
    if return_state:
        return y.to(x.dtype), state
    return y.to(x.dtype)


def ssd_decode_step(state, x_t, dt_t, A_log, B_t, C_t, D):
    """One-token state update.

    state ``[b,h,p,n]``; x_t ``[b,h,p]``; dt_t ``[b,h]``; B_t/C_t
    ``[b,g,n]``.  Returns ``(y_t [b,h,p], new_state)``.
    """
    b, h, p = x_t.shape
    g = B_t.shape[1]
    hpg = _heads_to_groups(h, g)
    A = -torch.exp(A_log.float())
    dtf = dt_t.float()
    a = torch.exp(dtf * A)                                     # [b,h]
    Bh = torch.repeat_interleave(B_t, hpg, dim=1).float()      # [b,h,n]
    Ch = torch.repeat_interleave(C_t, hpg, dim=1).float()
    upd = torch.einsum("bh,bhp,bhn->bhpn", dtf, x_t.float(), Bh)
    state = state * a[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = y + x_t.float() * D.float()[None, :, None]
    return y.to(x_t.dtype), state


# ---------------------------------------------------------------------------
# the full Mamba-2 mixer (projections + conv + SSD + gated norm)
# ---------------------------------------------------------------------------
class MambaCache(NamedTuple):
    conv: torch.Tensor   # [b, k-1, conv_dim] rolling window of pre-conv inputs
    ssm: torch.Tensor    # [b, h, p, n]


def mamba_param_shapes(d_model: int, *, d_inner: int, head_dim: int,
                       n_groups: int, d_state: int, conv_k: int):
    """Leaf name -> shape for one mamba layer (stacked by the caller)."""
    h = d_inner // head_dim
    conv_dim = d_inner + 2 * n_groups * d_state
    return {
        "mamba_norm": (d_model,),
        "mamba_in": (d_model, 2 * d_inner + 2 * n_groups * d_state + h),
        "mamba_conv": (conv_k, conv_dim),
        "mamba_A": (h,),
        "mamba_dt_bias": (h,),
        "mamba_D": (h,),
        "mamba_gnorm": (d_inner,),
        "mamba_out": (d_inner, d_model),
    }


def _split_in_proj(proj, d_inner, n_groups, d_state, h):
    """``proj [..., 2di+2gn+h]`` -> ``(z, xBC, dt)`` (views)."""
    xbc = d_inner + 2 * n_groups * d_state
    return torch.split(proj, [d_inner, xbc, h], dim=-1)


def _causal_conv(xBC, w):
    """Depthwise causal conv1d + SiLU: xBC ``[b,s,c]``, w ``[k,c]`` ->
    ``[b,s,c]``, a sum of ``k`` shifted scales in ``xBC``'s dtype, as the
    reference computes it."""
    k, s = w.shape[0], xBC.shape[1]
    xp = F.pad(xBC, (0, 0, k - 1, 0))
    out = xp[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i][None, None, :]
    return F.silu(out)


class HeadSplit(NamedTuple):
    """Rank ``r`` of ``m`` of a mixer split over its heads: the rank
    computes heads ``r·h/m … (r+1)·h/m`` and holds their blocks of the
    parameters (``mamba_in``'s ``r``-th block of columns, their rows of
    ``mamba_out``, their ``A``/``dt_bias``/``D``).  ``gather`` concatenates
    the ranks' blocks of a tensor's last dim in rank order (its gradient
    summed over the ranks and split back); ``total`` sums a tensor over the
    ranks (its gradient summed over the ranks as well: each rank's result
    feeds only that rank's heads)."""

    r: int
    m: int
    gather: Callable
    total: Callable


def _kept_channels(split: HeadSplit, d_inner: int, n_groups: int,
                   d_state: int, h: int):
    """The channels of ``[x | B | C]`` the rank's heads read, as
    ``(start, length)`` runs (its heads' block of ``x``; of ``B`` and ``C``
    the groups those heads read), and that number of groups."""
    hl, hpg = h // split.m, _heads_to_groups(h, n_groups)
    g0 = split.r * hl // hpg
    ng = ((split.r + 1) * hl - 1) // hpg + 1 - g0
    dl, gn = d_inner // split.m, n_groups * d_state
    return ((split.r * dl, dl), (d_inner + g0 * d_state, ng * d_state),
            (d_inner + gn + g0 * d_state, ng * d_state)), ng


def _take(t, runs):
    """The channels ``runs`` (see :func:`_kept_channels`) of ``t``'s last
    dim, in order."""
    return torch.cat([t.narrow(-1, a, n) for a, n in runs], dim=-1)


def _rank_share(split, z, xbc, dt, d_inner, n_groups, d_state, h):
    """The rank's share of the whole projection's ``z``, ``xBC`` (the kept
    channels) and ``dt``: ``(z, xBC, dt, its heads, its groups, the
    runs)``; all of it without ``split``."""
    if split is None:
        return z, xbc, dt, h, n_groups, None
    runs, ng = _kept_channels(split, d_inner, n_groups, d_state, h)
    hl = h // split.m
    return (z.narrow(-1, *runs[0]), _take(xbc, runs),
            dt.narrow(-1, split.r * hl, hl), hl, ng, runs)


def mamba2_mixer(p, x, *, head_dim: int, n_groups: int, d_state: int,
                 chunk: int = 128, impl: str = "chunked",
                 return_state: bool = False, split: HeadSplit | None = None):
    """Full Mamba-2 block body (pre-norm residual added by the caller).

    p: dict with keys from :func:`mamba_param_shapes`; x ``[b,s,D]``.
    ``impl``: ``"chunked"``, ``"recurrent"`` or ``"pallas"`` (K5).  With
    ``return_state`` also returns ``(conv_tail, ssm_state)`` so prefill can
    seed the decode cache; under ``"pallas"`` the state is K5's own, not a
    second pass through :func:`ssd_chunked` as in the reference.

    With ``split`` (:class:`HeadSplit`) ``p`` holds the rank's blocks and
    ``mamba_conv``, ``mamba_gnorm`` whole: the rank's block of the
    in-projection's columns is gathered into the whole projection, the
    conv runs over the channels its heads read, the SSD over its heads,
    the gated norm over all of ``d_inner`` (its sum of squares totalled
    over the ranks), and the output is the rank's partial product (summed
    over the ranks by the caller); the conv tail is every channel's, the
    SSM state the rank's heads'.
    """
    b, s, _ = x.shape
    d_inner = p["mamba_out"].shape[0] * (1 if split is None else split.m)
    h = d_inner // head_dim
    proj = x @ p["mamba_in"]                                   # [b,s,2di+2gn+h]
    if split is not None:
        proj = split.gather(proj)
    z, xBC_pre, dt = _split_in_proj(proj, d_inner, n_groups, d_state, h)
    z, xbc, dt, hl, ng, runs = _rank_share(split, z, xBC_pre, dt, d_inner,
                                           n_groups, d_state, h)
    w = p["mamba_conv"] if runs is None else _take(p["mamba_conv"], runs)
    xBC = _causal_conv(xbc, w)
    xs, B, C = torch.split(xBC, [hl * head_dim, ng * d_state,
                                 ng * d_state], dim=-1)
    xs = xs.reshape(b, s, hl, head_dim)
    B = B.reshape(b, s, ng, d_state)
    C = C.reshape(b, s, ng, d_state)
    dt = _softplus(dt.float() + p["mamba_dt_bias"].float())
    args = (xs, dt, p["mamba_A"], B, C, p["mamba_D"])
    state = None
    if impl == "recurrent":
        y, state = ssd_recurrent(*args)
    elif impl == "pallas":
        from repro_torch.kernels import ops as kops
        out = kops.ssd(*args, chunk=chunk, return_state=return_state)
        y, state = out if return_state else (out, None)
    elif impl == "chunked":
        y, state = ssd_chunked(*args, chunk=chunk, return_state=True)
    else:
        raise ValueError(f"unknown ssd impl {impl!r}")
    y = y.reshape(b, s, hl * head_dim)
    out = _gated_norm(y, z, p["mamba_gnorm"], x.dtype, split) \
        @ p["mamba_out"]
    if return_state:
        k = p["mamba_conv"].shape[0]
        # rolling conv window tail: last (k-1) *pre-conv* rows, zero-padded
        # on the left for sequences shorter than the window.
        tail = F.pad(xBC_pre, (0, 0, k - 1, 0))[:, -(k - 1):, :]
        return out, (tail.to(x.dtype), state)
    return out


def mamba2_init_cache(batch: int, *, d_inner: int, head_dim: int,
                      n_groups: int, d_state: int, conv_k: int,
                      dtype=torch.bfloat16, device=None) -> MambaCache:
    """Zeroed conv window (``dtype``) and SSM state (f32) on ``device``:
    ``cuda`` unless ``device="cpu"`` is passed."""
    device = resolve_device(device)
    h = d_inner // head_dim
    conv_dim = d_inner + 2 * n_groups * d_state
    return MambaCache(
        conv=torch.zeros((batch, conv_k - 1, conv_dim), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, h, head_dim, d_state), dtype=torch.float32,
                        device=device))


def mamba2_decode_step(p, x_t, cache: MambaCache, *, head_dim: int,
                       n_groups: int, d_state: int,
                       split: HeadSplit | None = None):
    """One-token mixer step.  x_t ``[b,D]``; returns ``(y_t [b,D],
    new_cache)``.  The conv of the window is taken in f32, as the
    reference's decode takes it.

    With ``split`` (see :func:`mamba2_mixer`) ``cache.conv`` and
    ``p["mamba_conv"]`` are the rank's ``r``-th block of the conv channels
    and ``cache.ssm`` its heads: the conv runs over that block (it is
    depthwise) and every channel's output is gathered; the new cache is
    the rank's blocks."""
    b, _ = x_t.shape
    d_inner = p["mamba_out"].shape[0] * (1 if split is None else split.m)
    h = d_inner // head_dim
    proj = x_t @ p["mamba_in"]
    if split is not None:
        proj = split.gather(proj)
    z, xBC, dt = _split_in_proj(proj, d_inner, n_groups, d_state, h)
    w = p["mamba_conv"]                                        # [k, c]
    if split is not None:
        xBC = xBC.narrow(-1, split.r * w.shape[1], w.shape[1])
    window = torch.cat([cache.conv, xBC[:, None, :]], dim=1)   # [b,k,c]
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window.float(),
                                   w.float())).to(x_t.dtype)
    new_conv = window[:, 1:, :]
    if split is not None:
        conv_out = split.gather(conv_out)
    z, conv_out, dt, hl, ng, _ = _rank_share(split, z, conv_out, dt,
                                             d_inner, n_groups, d_state, h)
    xs, B, C = torch.split(conv_out, [hl * head_dim, ng * d_state,
                                      ng * d_state], dim=-1)
    xs = xs.reshape(b, hl, head_dim)
    B = B.reshape(b, ng, d_state)
    C = C.reshape(b, ng, d_state)
    dt = _softplus(dt.float() + p["mamba_dt_bias"].float())
    y, new_ssm = ssd_decode_step(cache.ssm, xs, dt, p["mamba_A"], B, C,
                                 p["mamba_D"])
    y = y.reshape(b, hl * head_dim)
    yn = _gated_norm(y, z, p["mamba_gnorm"], x_t.dtype, split)
    return yn @ p["mamba_out"], MambaCache(conv=new_conv, ssm=new_ssm)
