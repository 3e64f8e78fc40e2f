"""Symmetric per-leaf int8 quantization for partial-aggregate uploads —
port of ``repro/compress/quant.py``.

Per leaf, in the reference's order: ``scale = max(max|x|, 1e-12) / 127``,
then ``clip(round(x / scale), -127, 127)`` (round half to even, as
``jnp.round``) cast to int8.  Every division is by a tensor, never by a
Python number: PyTorch on CUDA turns division by a host scalar into a
multiplication by its reciprocal, which rounds differently.

Trees are ``{name: tensor}`` dicts; the work runs on one flat buffer
(:class:`~repro_torch.kernels.layout.FlatLayout`), and the results are
:class:`~repro_torch.kernels.layout.FlatTree` views — the int8 payload
flat ``[N]``, the scales flat ``[n_leaves]``, as K2 takes them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.layout import FlatLayout

__all__ = ["int8_quantize", "int8_dequantize"]


def int8_quantize(tree: dict):
    """tree -> (int8 tree, scales tree); scale = max|v| / 127 per leaf."""
    layout = FlatLayout.of(tree)
    xf = layout.flatten(tree).float()
    mag = xf.abs()
    maxes = torch.stack([mag[o:o + n].max()
                         for o, n in zip(layout.offsets, layout.sizes)])
    scales = (torch.clamp(maxes, min=1e-12)
              / torch.full_like(maxes, 127.0))
    q = torch.clamp(torch.round(xf / layout.per_element(scales)), -127, 127)
    return layout.views(q.to(torch.int8)), layout.scalars().views(scales)


def int8_dequantize(qs: dict, scales: dict, like_tree: dict | None = None):
    """``q * scale`` per leaf, in f32 (or each ``like_tree`` leaf's dtype)."""
    out = {k: q.float() * scales[k] for k, q in qs.items()}
    if like_tree is not None:
        out = {k: v.to(like_tree[k].dtype) for k, v in out.items()}
    return out
