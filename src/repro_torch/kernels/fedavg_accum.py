"""K1 — the Eq. 1 streaming FedAvg fold as a hand-written CUDA kernel.

Replaces ``repro/kernels/fedavg_accum.py:41 fedavg_accum_2d`` (Pallas, TPU).
The kernel lives in ``csrc/fedavg_accum.cu``; this module binds it with
ctypes, checks its inputs and counts its launches.  It is bound by device
memory (2 reads + 1 write per element); see the source for the design.

Use :func:`repro_torch.kernels.ops.fedavg_accum`, which routes CPU tensors
to the plain version in :mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["fedavg_accum_lanes", "LAUNCHES"]

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts).
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC_BYTES = 16


def _lib() -> ctypes.CDLL:
    lib = build.load("fedavg_accum")
    if not getattr(lib, "_pollen_bound", False):
        vp = ctypes.c_void_p
        lib.pollen_fedavg_accum.argtypes = [vp, vp, vp, vp, vp,
                                            ctypes.c_longlong,
                                            ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, vp]
        lib.pollen_fedavg_accum.restype = ctypes.c_int
        lib.pollen_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pollen_cuda_error_string.restype = ctypes.c_char_p
        lib._pollen_bound = True
    return lib


def fedavg_accum_lanes(acc: torch.Tensor, theta: torch.Tensor,
                       n_old: torch.Tensor, n_k: torch.Tensor) -> torch.Tensor:
    """Fold ``theta`` into ``acc`` lane by lane, in one launch.

    acc, theta: ``[L, n]`` contiguous CUDA tensors of one dtype (f32 or
    bf16); n_old, n_k: ``[L]`` contiguous f32 on the same device.  Returns a
    new ``[L, n]`` tensor; lane ``l`` is Eq. 1 with weights
    ``n_old[l], n_k[l]``.  The weights are read on the device, so the call
    never synchronises with the host.
    """
    global LAUNCHES
    if acc.device.type != "cuda":
        raise ValueError(f"fedavg_accum_lanes needs CUDA tensors, got "
                         f"{acc.device}")
    if acc.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {acc.dtype}; f32 or bf16")
    if acc.ndim != 2:
        raise ValueError(f"acc must be [L, n], got {tuple(acc.shape)}")
    lanes, n = acc.shape
    if theta.shape != acc.shape or theta.dtype != acc.dtype:
        raise ValueError(f"theta {tuple(theta.shape)}/{theta.dtype} does not "
                         f"match acc {tuple(acc.shape)}/{acc.dtype}")
    for name, w in (("n_old", n_old), ("n_k", n_k)):
        if w.shape != (lanes,) or w.dtype != torch.float32:
            raise ValueError(f"{name} must be f32 [{lanes}], got "
                             f"{tuple(w.shape)}/{w.dtype}")
    tensors = (acc, theta, n_old, n_k)
    if any(t.device != acc.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if lanes > 65535:
        raise ValueError(f"at most 65535 lanes per launch, got {lanes}")
    out = torch.empty_like(acc)
    row_bytes = n * acc.element_size()
    vec = int(row_bytes % _VEC_BYTES == 0 and all(
        t.data_ptr() % _VEC_BYTES == 0 for t in (acc, theta, out)))
    lib = _lib()
    rc = lib.pollen_fedavg_accum(
        acc.data_ptr(), theta.data_ptr(), out.data_ptr(), n_old.data_ptr(),
        n_k.data_ptr(), lanes, n, _DTYPES[acc.dtype], vec,
        torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        msg = lib.pollen_cuda_error_string(rc).decode()
        raise RuntimeError(f"fedavg_accum launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return out
