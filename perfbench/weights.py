"""The weights of a cell, drawn from ``--seed`` on the card.

Every matrix is a standard normal clamped at ±2, times
``1/sqrt(fan_in)`` (the embedding: times 0.02); RMSNorm scales are 1.  The
draws come from one ``torch.Generator`` on the device, one ``randn`` for
all matrices together, then each leaf is cut out, scaled and cast to the
dtype the configuration states.  The benchmark hands the same weights to
the program and to the plain reference.
"""

from __future__ import annotations

import importlib
import math

import torch

__all__ = ["make_weights"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _leaf_dtypes(cfg: dict, names) -> dict:
    """Each leaf's dtype: the model's (``dtype`` or ``torch_dtype``), and
    float32 for the RMSNorm scales."""
    model = _DTYPES[cfg.get("torch_dtype", cfg.get("dtype", "float32"))]
    return {k: torch.float32 if "norm" in k else model for k in names}


def make_weights(cfg: dict, seed: int, device) -> dict:
    """``{leaf: tensor on device}`` at the configuration's shapes
    (:func:`perfbench.reference.<model>.shapes`)."""
    shapes = importlib.import_module(
        f"perfbench.reference.{cfg['model']}").shapes(cfg)
    dtypes = _leaf_dtypes(cfg, shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    mats = [k for k in shapes if "norm" not in k]
    total = sum(math.prod(shapes[k]) for k in mats)
    draw = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for k in shapes:
        shape = shapes[k]
        if k not in mats:
            out[k] = torch.ones(shape, dtype=dtypes[k], device=device)
            continue
        n = math.prod(shape)
        scale = 0.02 if k == "embed" else 1.0 / math.sqrt(shape[-2])
        out[k] = (draw[at:at + n].view(shape) * scale).to(dtypes[k])
        at += n
    del draw
    return out
