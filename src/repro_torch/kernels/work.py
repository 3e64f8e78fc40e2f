"""The work of one call of each hand-written kernel, from its shapes and
dtypes: the bytes it must move (each input read once, each output written
once) and the operations it must do, in the dtype its arithmetic runs in.

These are the counts a kernel's bound is reckoned from (the least time a
card could take: the larger of bytes over the memory rate and operations
over the peak rate of their dtype).  ``chip_smoke.py`` reads them for each
kernel's ``bound_ms``; the cost counter (:mod:`repro_torch.launch.op_cost`)
reads them for every call a counted step makes on meta tensors.

A call on meta tensors reports its work with :func:`record` to the counter
that :func:`counting` made active (none: the report is dropped).
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch

__all__ = ["Work", "fedavg_accum", "dequant_merge", "rmsnorm",
           "flash_attention", "ssd", "record", "counting"]


@dataclass(frozen=True)
class Work:
    """One kernel call's ``bytes`` moved and ``flops`` done; ``dtype`` is
    the dtype the arithmetic runs in (its peak rate bounds the flops)."""

    bytes: int
    flops: int
    dtype: torch.dtype


def _size(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def fedavg_accum(shape, dtype: torch.dtype) -> Work:
    """K1 on an ``acc``/``theta`` pair of ``shape``: 2 reads and 1 write of
    every element; 2 multiplies, an add and a divide in f32."""
    elems = 1
    for d in shape:
        elems *= int(d)
    return Work(3 * elems * _size(dtype), 4 * elems, torch.float32)


def dequant_merge(n: int) -> Work:
    """K2 on a flat payload of ``n`` elements: ``acc`` and ``g`` (f32) and
    ``q`` (int8) read, the f32 result written; the dequantize's multiply
    and add, then Eq. 1's 2 multiplies, add and divide, in f32."""
    return Work(13 * n, 6 * n, torch.float32)


def rmsnorm(rows: int, d: int, dtype: torch.dtype) -> Work:
    """K3 on ``rows`` rows of width ``d``: x read and y written in
    ``dtype``, the f32 scale read; square, add and 2 multiplies in f32."""
    return Work(2 * rows * d * _size(dtype) + d * 4, 4 * rows * d,
                torch.float32)


def flash_attention(q_shape, kv_shape, dtype: torch.dtype, *,
                    causal: bool) -> Work:
    """K4 on q ``[b, s, hq, d]`` and k/v ``[b, t, hkv, d]``: q, k, v read
    and the output written once; QK^T and PV over the (query, key) pairs
    that are not masked (causal: key ``j <= i`` for query ``i``)."""
    b, s, hq, d = (int(x) for x in q_shape)
    t, hkv = int(kv_shape[1]), int(kv_shape[2])
    if causal:
        pairs = sum(min(i + 1, t) for i in range(s)) if s > t \
            else s * (s + 1) // 2
    else:
        pairs = s * t
    elems = 2 * b * s * hq * d + 2 * b * t * hkv * d     # q, out; k, v
    return Work(elems * _size(dtype), 4 * b * hq * pairs * d, dtype)


def ssd(x_shape, B_shape, dtype: torch.dtype, dt_dtype: torch.dtype, *,
        chunk: int, state: bool) -> Work:
    """K5 on x ``[b, s, h, p]`` and B/C ``[b, s, g, n]`` at chunk ``chunk``
    (the chunk the route runs with): each input read once (x, B, C in
    ``dtype``; dt ``[b, s, h]`` in ``dt_dtype``; A_log and D f32), y
    written once, and with ``state`` the f32 final state ``[b, h, p, n]``;
    C B^T once per group and chunk (its lower triangle), the masked
    intra-chunk product, C · state for every chunk after the first, and
    the state update."""
    b, s, h, p = (int(x) for x in x_shape)
    g, n = int(B_shape[2]), int(B_shape[3])
    item = _size(dtype)
    nbytes = (b * s * h * p * item                      # x
              + b * s * h * _size(dt_dtype)             # dt
              + 2 * h * 4                               # A_log, D
              + 2 * b * s * g * n * item                # B, C
              + b * s * h * p * item                    # y
              + (b * h * p * n * 4 if state else 0))
    rows = [min(chunk, s - t0) for t0 in range(0, s, chunk)]
    tri = sum(r * (r + 1) // 2 for r in rows)
    flops = (2 * b * g * tri * n                        # C B^T
             + 2 * b * h * tri * p                      # (C B^T * L)(x dt)
             + 2 * b * h * (s - rows[0]) * n * p        # C . state
             + 2 * b * h * s * p * n)                   # the state update
    return Work(nbytes, flops, dtype)


_COUNTER: contextvars.ContextVar = contextvars.ContextVar("kernel_work",
                                                          default=None)


def record(kernel: str, work: Work) -> None:
    """Report one meta call's work to the active counter, if any."""
    sink = _COUNTER.get()
    if sink is not None:
        sink(kernel, work)


@contextlib.contextmanager
def counting(sink):
    """Make ``sink(kernel, work)`` the receiver of :func:`record` inside
    the block."""
    token = _COUNTER.set(sink)
    try:
        yield
    finally:
        _COUNTER.reset(token)
