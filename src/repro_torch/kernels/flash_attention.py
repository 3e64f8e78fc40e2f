"""K4 — causal (or full) GQA attention with an online softmax, as a
hand-written CUDA kernel.

Replaces ``repro/kernels/flash_attention.py:89 flash_attention_bhsd``
(Pallas, TPU).  The kernels live in ``csrc/flash_attention.cu``; this
module binds them with ctypes, checks their inputs and counts their
launches.  They read the model layout ``[b, s, h, d]`` through strides (no
transposes, no padded copies).  K4 is bound by operations at the serve
shapes.  Two routes, chosen by :func:`route` from the dtype and head dim
before any launch: bf16 at d = 64 and 128 takes the ``"wgmma"`` kernel
(tensor cores fed by TMA, P rounded to bf16 before P·V); f32 (``wgmma``
would be TF32) and bf16 at d = 16 and 32 take the ``"simt"`` kernel (f32
FMAs).  A bf16 input that the ``wgmma`` route cannot address raises; it does
not move to the other route.  See the source for the designs.

Use :func:`repro_torch.kernels.ops.flash_attention`, which routes CPU
tensors to the plain version and applies the reference wrapper's padding
semantics.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

__all__ = ["flash_attention_bshd", "route", "check_tma", "LAUNCHES",
           "ROUTE_LAUNCHES", "HEAD_DIMS", "WGMMA_HEAD_DIMS"]

# Launches of the CUDA kernels since the last reset (ops.reset_launch_counts):
# all routes, and by route.
LAUNCHES = 0
ROUTE_LAUNCHES = {"simt": 0, "wgmma": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)       # the kernels are compiled for these
WGMMA_HEAD_DIMS = (64, 128)         # bf16 at these takes the wgmma kernel
_TMA_ALIGN = 16                     # bytes: TMA's rule for bases and strides


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a call of this dtype and head dim launches: ``"wgmma"``
    for bf16 at d in :data:`WGMMA_HEAD_DIMS`, else ``"simt"`` (the rule of
    ``pollen_flash_attention_route`` in the source)."""
    return "wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS \
        else "simt"


def check_tma(**tensors) -> None:
    """The wgmma routes (K4's and K5's) read through TMA: every base
    address and every stride of a dim longer than 1 must be a multiple of
    16 bytes."""
    for name, x in tensors.items():
        if x.data_ptr() % _TMA_ALIGN:
            raise ValueError(f"wgmma route: {name} does not start on a "
                             f"{_TMA_ALIGN}-byte boundary")
        for dim in range(3):
            if x.shape[dim] > 1 and x.stride(dim) * x.element_size() \
                    % _TMA_ALIGN:
                raise ValueError(
                    f"wgmma route: {name}'s stride {x.stride(dim)} (dim "
                    f"{dim}) is not a multiple of {_TMA_ALIGN} bytes")


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_pollen_bound", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.pollen_flash_attention.argtypes = (
            [vp] * 4 + [ll] * 9 + [i] * 9 + [ctypes.c_float, vp])
        lib.pollen_flash_attention.restype = ctypes.c_int
        lib.pollen_flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.pollen_flash_attention_error_string.restype = ctypes.c_char_p
        lib.pollen_flash_attention_route.argtypes = [i, i]
        lib.pollen_flash_attention_route.restype = i
        lib._pollen_bound = True
    return lib


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, t_pad: int) -> torch.Tensor:
    """Attention in the model layout, in one launch.

    q: ``[b, s, hq, d]``; k, v: ``[b, t, hkv, d]``; CUDA tensors of one
    dtype (f32 or bf16) whose last dim is contiguous (other strides are
    free); ``d`` in :data:`HEAD_DIMS`; ``hq`` a multiple of ``hkv``.  Keys
    ``t <= j < t_pad`` count as zero vectors (the reference wrapper's zero
    padding); a causal query ``i`` sees keys ``j <= i``.  Returns a new
    contiguous ``[b, s, hq, d]`` tensor of ``q``'s dtype.  On the ``wgmma``
    route every base and stride must be a multiple of 16 bytes.
    """
    global LAUNCHES
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bshd needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}; f32 or bf16")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k, v must be [b, s, h, d]")
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if k.shape != (b, t, hkv, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share one dtype")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not compiled; one of {HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq {hq} not a multiple of Hkv {hkv}")
    if t == 0 or not t <= t_pad < 2**31 or s >= 2**31:
        raise ValueError(f"lengths s {s}, t {t}, t_pad {t_pad} out of range")
    if b > 65535 or hq > 65535:
        raise ValueError(f"batch {b} / heads {hq}: at most 65535 each")
    if any(x.device != q.device for x in (k, v)):
        raise ValueError("all inputs must be on one device")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("the head dim of q, k, v must be contiguous")
    path = route(q.dtype, d)
    if path == "wgmma" and b and s:
        check_tma(q=q, k=k, v=v)
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    lib = _lib()
    rc = lib.pollen_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        b, s, t, t_pad, hq, hkv, d, int(causal), _DTYPES[q.dtype],
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = lib.pollen_flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({rc})")
    if b and s:                           # an empty batch launches nothing
        LAUNCHES += 1
        ROUTE_LAUNCHES[path] += 1
    return out
