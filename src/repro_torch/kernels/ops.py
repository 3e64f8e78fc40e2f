"""Public wrappers around the port's kernels.

They adapt any-shape leaves to the kernel layouts.  A tensor on the CPU
takes the plain version (``ref``); a CUDA tensor launches the hand-written
kernel or raises — there is no fallback.  A meta tensor (a step counted by
:mod:`repro_torch.launch.op_cost`) computes nothing: the route returns
empty meta outputs of the kernel's shapes and reports the call's work
(:mod:`repro_torch.kernels.work`) to the active counter.  A meta call is
not a launch; any other device raises.

    fedavg_accum(acc, theta, n_old, n_k)          — any-shape leaf, or a
                                                    lane-stacked [L, ...]
                                                    leaf with [L] weights
    dequant_merge(acc, q, g, scale, n_old, n_k)   — any-shape leaf
    dequant_merge_flat(acc, q, g, scales, offsets, n_old, n_k)
                                                  — a flat [N] buffer of
                                                    several leaves, one
                                                    scale per leaf
    rmsnorm(x, scale, eps=...)                    — [..., D]
    flash_attention(q, k, v, causal=...)          — [b, s, h, d] model layout
    ssd(x, dt, A_log, B, C, D, chunk=..., return_state=...)
                                                  — [b, s, h, p] model layout
"""

from __future__ import annotations

import torch

from repro_torch.kernels import dequant_merge as _dm
from repro_torch.kernels import fedavg_accum as _fa
from repro_torch.kernels import flash_attention as _fl
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import work

__all__ = ["fedavg_accum", "dequant_merge", "dequant_merge_flat", "rmsnorm",
           "flash_attention", "padded_kv_len", "ssd", "ssd_chunk",
           "launch_counts", "reset_launch_counts"]

_KERNELS = {"fedavg_accum": _fa, "dequant_merge": _dm, "rmsnorm": _rn,
            "flash_attention": _fl, "ssd": _ssd}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: mod.LAUNCHES for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.LAUNCHES = 0
    _fl.ROUTE_LAUNCHES.update(dict.fromkeys(_fl.ROUTE_LAUNCHES, 0))
    _ssd.ROUTE_LAUNCHES.update(dict.fromkeys(_ssd.ROUTE_LAUNCHES, 0))


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


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
    if acc.device.type == "meta":
        work.record("fedavg_accum", work.fedavg_accum(acc.shape, acc.dtype))
        return torch.empty_like(acc)
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
    if acc.device.type == "meta":
        work.record("dequant_merge", work.dequant_merge(acc.numel()))
        return torch.empty_like(acc)
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


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """RMSNorm over the last dim of ``x`` (any leading shape), as
    ``repro.kernels.ops.rmsnorm``: f32 math, output in ``x.dtype``."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps)
    d = x.shape[-1]
    if x.device.type == "meta":
        work.record("rmsnorm", work.rmsnorm(x.numel() // d, d, x.dtype))
        return torch.empty_like(x)
    if x.device.type != "cuda":
        raise ValueError(f"no rmsnorm kernel for device {x.device}")
    out = _rn.rmsnorm_rows(x.reshape(-1, d).contiguous(),
                           scale.to(torch.float32).contiguous(), eps)
    return out.reshape(x.shape)


def padded_kv_len(t: int) -> int:
    """``t`` padded as the reference wrapper pads it at its default kv block:
    to a multiple of ``min(256, round_up(t, 128))``."""
    return _round_up(t, min(256, _round_up(t, 128)))


def flash_attention(q, k, v, *, causal: bool = True):
    """Attention in the model layout ``[b, s, h, d]`` in and out, as
    ``repro.kernels.ops.flash_attention`` at its default blocks.

    The reference wrapper pads ``t`` with zero keys to a multiple of its kv
    block (``padded_kv_len``); a causal query at or past ``t`` sees those
    zeros, and non-causal attention on a ``t`` that needs padding raises
    ``NotImplementedError`` — both kept here.  The CUDA kernel reads the
    model layout through strides and takes the padded length as an
    argument, so nothing is copied.
    """
    t = k.shape[1]
    tp = padded_kv_len(t)
    if tp != t and not causal:
        raise NotImplementedError("non-causal padding unsupported; pad t to "
                                  "a block multiple upstream")
    if q.device.type == "cpu":
        return ref.flash_attention_bshd_ref(q, k, v, causal=causal, t_pad=tp)
    if q.device.type == "meta":
        work.record("flash_attention", work.flash_attention(
            q.shape, k.shape, q.dtype, causal=causal))
        return torch.empty_like(q, memory_format=torch.contiguous_format)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    return _fl.flash_attention_bshd(q, k, v, causal=causal, t_pad=tp)


def ssd_chunk(s: int, chunk: int = 128) -> int:
    """The chunk the reference wrapper runs a sequence of ``s`` rows with:
    ``min(chunk, round_up(s, 8))``."""
    return min(chunk, _round_up(s, 8))


def ssd(x, dt, A_log, B, C, D, *, chunk: int = 128,
        return_state: bool = False):
    """Mamba-2's chunked SSD in the model layout, as
    ``repro.kernels.ops.ssd``: x ``[b, s, h, p]``, dt ``[b, s, h]``, A_log
    and D ``[h]``, B/C ``[b, s, g, n]``; returns y ``[b, s, h, p]`` in x's
    dtype (f32 math), and with ``return_state`` also the final state
    ``[b, h, p, n]`` f32.

    The chunk is the reference wrapper's (:func:`ssd_chunk`), and the
    ragged tail of ``s`` counts as zero rows, as its padding does.  The
    CUDA kernel reads the model layout through strides and masks the tail
    from the true ``s``, so nothing is copied.
    """
    s = x.shape[1]
    if s == 0:
        raise ValueError("ssd needs at least one row")
    ck = ssd_chunk(s, chunk)
    dt = dt.float()
    A_log, D = A_log.float(), D.float()
    if x.device.type == "cpu":
        y, state = ref.ssd_chunks_ref(x, dt, A_log, B, C, D, chunk=ck)
        return (y, state) if return_state else y
    if x.device.type == "meta":
        work.record("ssd", work.ssd(x.shape, B.shape, x.dtype, dt.dtype,
                                    chunk=ck, state=return_state))
        y = torch.empty_like(x, memory_format=torch.contiguous_format)
        b, _, h, p = x.shape
        state = x.new_empty((b, h, p, B.shape[-1]), dtype=torch.float32)
        return (y, state) if return_state else y
    if x.device.type != "cuda":
        raise ValueError(f"no ssd kernel for device {x.device}")
    return _ssd.ssd_bshp(x, dt, A_log.contiguous(), B, C, D.contiguous(),
                         chunk=ck, want_state=return_state)
