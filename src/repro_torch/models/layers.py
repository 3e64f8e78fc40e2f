"""Shared layer helpers (port of the parts of ``repro/models/layers.py``
the ported models use)."""

from __future__ import annotations

import math

import torch

__all__ = ["dense_init"]


def dense_init(gen: torch.Generator, shape, dtype=torch.float32, *,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at ±2, times ``scale``
    (default ``1/sqrt(fan_in)``).

    Drawn on the CPU from ``gen`` with ``torch.randn`` and redrawn where
    ``|x| > 2``.  ``torch.nn.init.trunc_normal_`` is not used: its draws
    for one seeded generator differ between PyTorch releases (2.11 and 2.13
    give different SR weights), while ``randn``'s do not — so a seed gives
    the same weights on every machine and device.
    """
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=gen)
    bad = w.abs() > 2.0
    while bool(bad.any()):
        w[bad] = torch.randn(int(bad.sum()), generator=gen)
        bad = w.abs() > 2.0
    return (w * s).to(dtype)
