"""K3 — RMSNorm over the last dim as a hand-written CUDA kernel.

Replaces ``repro/kernels/rmsnorm.py:30 rmsnorm_2d`` (Pallas, TPU).  The
kernel lives in ``csrc/rmsnorm.cu``; this module binds it with ctypes,
checks its inputs and counts its launches.  It is bound by device memory
(one read and one write per element).  Rows of whole 16-byte vectors up to
d = 1024 in bf16 (512 in f32) are held in registers by ``min(32,
next_pow2(vectors))`` lanes each, so a warp takes several short rows;
longer rows take a warp each (:func:`geometry`).  See the source for the
design.

Use :func:`repro_torch.kernels.ops.rmsnorm`, which routes CPU tensors to
the plain version :func:`repro_torch.kernels.ref.rmsnorm_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["rmsnorm_rows", "geometry", "vector_ok", "LAUNCHES"]

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts).
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_BYTES = 16
_MAX_VECS = 4           # vectors a lane holds on the register path
PATHS = ("elements", "loop", "registers")


def geometry(d: int, itemsize: int, vec: bool) -> dict:
    """How the kernel lays a row of ``d`` elements of ``itemsize`` bytes
    over lanes (``pollen_rmsnorm_geometry`` in the source): its ``path``,
    ``lanes_per_row``, ``rows_per_warp`` and ``vectors_per_lane``.  ``vec``
    says whether rows are whole, aligned 16-byte vectors."""
    if not vec:
        return {"path": "elements", "lanes_per_row": 32, "rows_per_warp": 1,
                "vectors_per_lane": 0}
    n_vec = d // (_VEC_BYTES // itemsize)
    lanes = 1
    while lanes < n_vec and lanes < 32:
        lanes *= 2
    vecs = 1
    while vecs * lanes < n_vec:
        vecs *= 2
    if vecs > _MAX_VECS:
        return {"path": "loop", "lanes_per_row": 32, "rows_per_warp": 1,
                "vectors_per_lane": 0}
    return {"path": "registers", "lanes_per_row": lanes,
            "rows_per_warp": 32 // lanes, "vectors_per_lane": vecs}


def vector_ok(x: torch.Tensor, out: torch.Tensor,
              scale: torch.Tensor) -> bool:
    """Whether the vector and register paths may run: a row is whole
    16-byte vectors and ``x``, ``out`` and ``scale`` all start on a 16-byte
    boundary (the register path reads ``scale`` as ``float4``s).  Otherwise
    the kernel takes its element path; nothing is copied."""
    return (x.shape[-1] * x.element_size()) % _VEC_BYTES == 0 and all(
        t.data_ptr() % _VEC_BYTES == 0 for t in (x, out, scale))


def _lib() -> ctypes.CDLL:
    lib = build.load("rmsnorm")
    if not getattr(lib, "_pollen_bound", False):
        vp = ctypes.c_void_p
        lib.pollen_rmsnorm.argtypes = [vp, vp, vp, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_float,
                                       ctypes.c_int, ctypes.c_int, vp]
        lib.pollen_rmsnorm.restype = ctypes.c_int
        lib.pollen_rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.pollen_rmsnorm_error_string.restype = ctypes.c_char_p
        lib.pollen_rmsnorm_geometry.argtypes = [ctypes.c_int] * 3 + [vp]
        lib.pollen_rmsnorm_geometry.restype = None
        lib._pollen_bound = True
    return lib


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """Normalise every row of ``x`` in one launch.

    x: ``[rows, d]`` contiguous CUDA tensor, f32 or bf16; scale: ``[d]``
    contiguous f32 on the same device.  Returns a new ``[rows, d]`` tensor
    of ``x``'s dtype: ``x * rsqrt(mean(x^2) + eps) * scale`` in f32.
    """
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm_rows needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}; f32 or bf16")
    if x.ndim != 2:
        raise ValueError(f"x must be [rows, d], got {tuple(x.shape)}")
    rows, d = x.shape
    if scale.shape != (d,) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be f32 [{d}], got {tuple(scale.shape)}"
                         f"/{scale.dtype}")
    if scale.device != x.device:
        raise ValueError("all inputs must be on one device")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("inputs must be contiguous")
    if d == 0 or d > 2**31 - 1:
        raise ValueError(f"row length {d} out of range")
    out = torch.empty_like(x)
    vec = int(vector_ok(x, out, scale))
    lib = _lib()
    rc = lib.pollen_rmsnorm(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                            rows, d, float(eps), _DTYPES[x.dtype], vec,
                            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = lib.pollen_rmsnorm_error_string(rc).decode()
        raise RuntimeError(f"rmsnorm launch failed: {msg} ({rc})")
    if rows:                              # no rows launches nothing
        LAUNCHES += 1
    return out
