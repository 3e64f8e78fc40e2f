"""K5 — Mamba-2's chunked SSD as a hand-written CUDA kernel.

Replaces ``repro/kernels/ssd.py:83 ssd_bhsp`` (Pallas, TPU).  The kernels
live in ``csrc/ssd.cu``; this module binds them with ctypes, checks their
inputs and counts their launches.  One block runs one (batch, head) over
every chunk with the ``[p, n]`` state on chip; it reads the model layout
(``x [b, s, h, p]``, ``B``/``C`` ``[b, s, g, n]``) through strides and
masks the ragged tail from the true ``s``, so nothing is transposed or
padded in memory.  Two routes, chosen by :func:`route` before any launch:
bf16 at head dim 64 (any state width that is whole 16-byte rows, any
chunk) takes the ``"wgmma"`` kernel (tensor-core products from bf16
operands, the f32 operands as hi + lo bf16 pairs, chunk tiles loaded by
TMA one chunk ahead); f32 (``wgmma`` would be TF32) and bf16 at
other head dims take the ``"simt"`` kernel (f32 FMAs).  A bf16 input that
the ``wgmma`` route cannot address raises; it does not move to the other
route.  See the source for the designs.

Use :func:`repro_torch.kernels.ops.ssd`, which routes CPU tensors to the
plain version :func:`repro_torch.kernels.ref.ssd_chunks_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import check_tma

__all__ = ["ssd_bshp", "route", "LAUNCHES", "ROUTE_LAUNCHES"]

# Launches of the CUDA kernels since the last reset (ops.reset_launch_counts):
# all routes, and by route.
LAUNCHES = 0
ROUTE_LAUNCHES = {"simt": 0, "wgmma": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128
WGMMA_HEAD_DIM = 64                 # bf16 at this head dim takes wgmma


def route(dtype: torch.dtype, p: int, n: int, chunk: int) -> str:
    """The kernel a call of this dtype, head dim ``p``, state width ``n``
    and chunk launches: ``"wgmma"`` for bf16 at ``p`` = 64 with ``n`` a
    multiple of 8 (whole 16-byte rows), else ``"simt"`` (the rule of
    ``pollen_ssd_route`` in the source).  Every chunk up to
    :data:`MAX_CHUNK` takes the route its dtype and widths name: the
    ``wgmma`` kernel pads a chunk to 128 rows with zeros."""
    del chunk
    return "wgmma" if (dtype == torch.bfloat16 and p == WGMMA_HEAD_DIM
                       and n % 8 == 0) else "simt"


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd")
    if not getattr(lib, "_pollen_bound", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.pollen_ssd.argtypes = [vp] * 8 + [ll] * 12 + [i] * 8 + [vp]
        lib.pollen_ssd.restype = ctypes.c_int
        lib.pollen_ssd_error_string.argtypes = [ctypes.c_int]
        lib.pollen_ssd_error_string.restype = ctypes.c_char_p
        lib.pollen_ssd_route.argtypes = [i] * 4
        lib.pollen_ssd_route.restype = i
        lib._pollen_bound = True
    return lib


def ssd_bshp(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
             chunk: int, want_state: bool = False):
    """The chunked SSD over the whole sequence, in one launch.

    x: ``[b, s, h, p]``; B, C: ``[b, s, g, n]`` of x's dtype (f32 or bf16);
    dt: ``[b, s, h]`` f32; A_log, D: ``[h]`` f32.  CUDA tensors whose last
    dim is contiguous (other strides are free); ``p <= 64``, ``n <= 128``,
    ``chunk <= 128``; ``h`` a multiple of ``g``.  Chunks start at multiples
    of ``chunk``, and rows at or past ``s`` count as zeros.  Returns ``y``, a
    new contiguous ``[b, s, h, p]`` tensor of x's dtype, and with
    ``want_state`` also the final state, ``[b, h, p, n]`` f32.  On the
    ``wgmma`` route every base and stride of x, B and C must be a multiple
    of 16 bytes.
    """
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"ssd_bshp needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}; f32 or bf16")
    if x.ndim != 4 or B.ndim != 4 or C.ndim != 4 or dt.ndim != 3:
        raise ValueError("x must be [b, s, h, p], B and C [b, s, g, n], "
                         "dt [b, s, h]")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if B.shape[:2] != (b, s) or C.shape != B.shape:
        raise ValueError(f"B {tuple(B.shape)} / C {tuple(C.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if dt.shape != (b, s, h):
        raise ValueError(f"dt {tuple(dt.shape)} is not [{b}, {s}, {h}]")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError("x, B and C must share one dtype")
    for name, t in (("dt", dt), ("A_log", A_log), ("D", D)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be f32, got {t.dtype}")
    if A_log.shape != (h,) or D.shape != (h,):
        raise ValueError(f"A_log and D must be [{h}]")
    if not (A_log.is_contiguous() and D.is_contiguous()):
        raise ValueError("A_log and D must be contiguous")
    if g == 0 or h % g:
        raise ValueError(f"heads {h} not divisible by groups {g}")
    if not (0 < p <= MAX_HEAD_DIM and 0 < n <= MAX_STATE
            and 0 < chunk <= MAX_CHUNK):
        raise ValueError(f"head dim {p} (<= {MAX_HEAD_DIM}), state {n} (<= "
                         f"{MAX_STATE}) or chunk {chunk} (<= {MAX_CHUNK}) "
                         f"out of range")
    if b > 65535 or h > 65535 or not 0 < s < 2**31:
        raise ValueError(f"batch {b} / heads {h} / length {s} out of range")
    if any(t.device != x.device for t in (dt, A_log, B, C, D)):
        raise ValueError("all inputs must be on one device")
    if any(t.stride(-1) != 1 for t in (x, B, C)):
        raise ValueError("the last dim of x, B and C must be contiguous")
    path = route(x.dtype, p, n, chunk)
    if path == "wgmma" and b:
        check_tma(x=x, B=B, C=C)
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = (torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
             if want_state else None)
    lib = _lib()
    rc = lib.pollen_ssd(
        x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(),
        None if state is None else state.data_ptr(),
        *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
        b, s, h, g, p, n, chunk, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = lib.pollen_ssd_error_string(rc).decode()
        raise RuntimeError(f"ssd launch failed: {msg} ({rc})")
    if b:                                 # an empty batch launches nothing
        LAUNCHES += 1
        ROUTE_LAUNCHES[path] += 1
    return (y, state) if want_state else y
