"""Matrix products for the plain references, at the configuration's
precision or, for a control, at the nearest precision below it.

``matmul(a, b, q)`` is ``a @ b`` when ``q`` is None.  With a quantiser
``q`` both operands are rounded by it before the product, in forward and
in backward (the gradient too), so the reference computes as a program
would that multiplies in that precision:

* ``tf32``: float32 operands rounded to TF32's 10-bit mantissa (round to
  nearest even), which is what a float32 GEMM with TF32 on reads;
* ``fp8``: operands scaled per tensor into float8 e4m3's range, cast to
  it and back, the usual per-tensor scaled fp8 GEMM.

The products themselves accumulate in the operands' dtype as PyTorch's
``@`` does, so the only change is the rounding of what goes in.
"""

from __future__ import annotations

import torch

__all__ = ["matmul", "QUANTISERS"]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    # Round to nearest even on the 13 dropped mantissa bits.
    lsb = (i >> 13) & 1
    i = (i + 0xFFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


_E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / _E4M3_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn)
    return (q.float() * scale).to(x.dtype)


QUANTISERS = {"tf32": _tf32, "fp8": _fp8}


class _LowMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, q):
        qa, qb = q(a), q(b)
        ctx.save_for_backward(qa, qb)
        ctx.q = q
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = ctx.q(g.contiguous())
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = qg @ qb.transpose(-1, -2)
        if ctx.needs_input_grad[1]:
            gb = qa.transpose(-1, -2) @ qg
            # A broadcast operand's gradient sums over the batch dims.
            while gb.ndim > qb.ndim:
                gb = gb.sum(0)
        return ga, gb, None


def matmul(a: torch.Tensor, b: torch.Tensor, q=None) -> torch.Tensor:
    if q is None:
        return a @ b
    return _LowMatmul.apply(a, b, q)
