"""K2 — the compressed combine's fused int8 dequantize + Eq. 1 fold as a
hand-written CUDA kernel.

Replaces ``repro/kernels/dequant_merge.py:46 dequant_merge_2d`` (Pallas,
TPU).  The kernel lives in ``csrc/dequant_merge.cu``; this module binds it
with ctypes, checks its inputs and counts its launches.  One launch folds
one shard's whole flat payload over every leaf; it is bound by device
memory (13 bytes per element).  See the source for the design.

Use :func:`repro_torch.kernels.ops.dequant_merge` (one leaf) or
:func:`repro_torch.kernels.ops.dequant_merge_flat` (a flat multi-leaf
buffer), which route CPU tensors to the plain versions in
:mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["dequant_merge_flat", "LAUNCHES", "MAX_LEAVES"]

# Launches of the CUDA kernel since the last reset (ops.reset_launch_counts).
LAUNCHES = 0
MAX_LEAVES = 2048
_VEC_BYTES = 16


def _lib() -> ctypes.CDLL:
    lib = build.load("dequant_merge")
    if not getattr(lib, "_pollen_bound", False):
        vp = ctypes.c_void_p
        lib.pollen_dequant_merge.argtypes = [vp, vp, vp, vp, vp, vp,
                                             ctypes.c_int, ctypes.c_longlong,
                                             vp, vp, ctypes.c_int, vp]
        lib.pollen_dequant_merge.restype = ctypes.c_int
        lib.pollen_dequant_merge_error_string.argtypes = [ctypes.c_int]
        lib.pollen_dequant_merge_error_string.restype = ctypes.c_char_p
        lib._pollen_bound = True
    return lib


def dequant_merge_flat(acc: torch.Tensor, q: torch.Tensor, g: torch.Tensor,
                       scales: torch.Tensor, offsets: torch.Tensor,
                       n_old: torch.Tensor, n_k: torch.Tensor) -> torch.Tensor:
    """Fold one int8 payload into ``acc`` over every leaf, in one launch.

    acc, g: ``[N]`` contiguous f32 CUDA tensors; q: ``[N]`` contiguous int8;
    scales: f32 ``[L]``; offsets: int64 ``[L + 1]`` leaf boundaries with
    ``offsets[0] == 0`` and ``offsets[L] == N`` (not checked: reading them
    would sync the host); n_old, n_k: one f32 each.  All on one device.
    Returns a new ``[N]`` f32 tensor.  Nothing is read on the host.
    """
    global LAUNCHES
    if acc.device.type != "cuda":
        raise ValueError(f"dequant_merge_flat needs CUDA tensors, got "
                         f"{acc.device}")
    if acc.ndim != 1 or acc.dtype != torch.float32:
        raise TypeError(f"acc must be f32 [N], got {tuple(acc.shape)}/"
                        f"{acc.dtype}")
    n = acc.shape[0]
    if g.shape != acc.shape or g.dtype != torch.float32:
        raise ValueError(f"g {tuple(g.shape)}/{g.dtype} does not match acc "
                         f"{tuple(acc.shape)}/f32")
    if q.shape != acc.shape or q.dtype != torch.int8:
        raise ValueError(f"q must be int8 [{n}], got {tuple(q.shape)}/"
                         f"{q.dtype}")
    n_leaves = scales.numel()
    if scales.dtype != torch.float32 or scales.ndim != 1:
        raise ValueError(f"scales must be f32 [L], got {tuple(scales.shape)}"
                         f"/{scales.dtype}")
    if not 1 <= n_leaves <= MAX_LEAVES:
        raise ValueError(f"1 to {MAX_LEAVES} leaves per launch, got "
                         f"{n_leaves}")
    if offsets.shape != (n_leaves + 1,) or offsets.dtype != torch.int64:
        raise ValueError(f"offsets must be int64 [{n_leaves + 1}], got "
                         f"{tuple(offsets.shape)}/{offsets.dtype}")
    for name, w in (("n_old", n_old), ("n_k", n_k)):
        if w.numel() != 1 or w.dtype != torch.float32:
            raise ValueError(f"{name} must be one f32, got "
                             f"{tuple(w.shape)}/{w.dtype}")
    tensors = (acc, q, g, scales, offsets, n_old, n_k)
    if any(t.device != acc.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    out = torch.empty_like(acc)
    vec = int(all(t.data_ptr() % _VEC_BYTES == 0 for t in (acc, q, g, out)))
    lib = _lib()
    rc = lib.pollen_dequant_merge(
        acc.data_ptr(), q.data_ptr(), g.data_ptr(), out.data_ptr(),
        scales.data_ptr(), offsets.data_ptr(), n_leaves, n,
        n_old.data_ptr(), n_k.data_ptr(), vec,
        torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        msg = lib.pollen_dequant_merge_error_string(rc).decode()
        raise RuntimeError(f"dequant_merge launch failed: {msg} ({rc})")
    if n:                                # an empty buffer launches nothing
        LAUNCHES += 1
    return out
