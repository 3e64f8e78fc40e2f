"""Top-k sparsification with error feedback (Stich et al. style) — port of
``repro/compress/topk.py``.

Per leaf, the largest-|v| fraction of ``v = update + error`` is sent; the
unsent remainder becomes the new error, added back before the next
selection — nothing is lost, only delayed.  ``frac`` is a Python float,
and :func:`topk_k` does the size math in exact integer arithmetic, so equal
``(size, frac)`` always give equal payload shapes.

``torch.topk`` may order equal magnitudes differently from
``jax.lax.top_k``; the decoded dense update and the residual are what must
agree, never the index order.  The scatter of the sent values uses
``index_put_`` without accumulation (unique indices), which stays legal
under ``torch.use_deterministic_algorithms(True)``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.kernels.layout import FlatLayout

__all__ = ["TopKState", "topk_init", "topk_compress", "topk_decompress",
           "topk_k"]


class TopKState(NamedTuple):
    error: Any  # residual tree (same structure as the updates)


def topk_init(like_tree: dict) -> TopKState:
    return TopKState(error={k: torch.zeros_like(v)
                            for k, v in like_tree.items()})


def _check_frac(frac) -> float:
    """Validate the sparsification fraction: a Python float in (0, 1]."""
    if not isinstance(frac, (int, float)):
        raise TypeError(
            "topk frac must be a python float (it determines payload "
            f"shapes); got {type(frac).__name__}")
    frac = float(frac)
    if not 0.0 < frac <= 1.0:
        raise ValueError(f"topk frac must be in (0, 1], got {frac!r}")
    return frac


def topk_k(size: int, frac: float) -> int:
    """Per-leaf k for a leaf of ``size`` elements: at least 1, at most
    ``size``, round-half-up on the exact rational ``size * frac``."""
    num, den = float(frac).as_integer_ratio()
    k = (size * num + den // 2) // den
    return max(1, min(size, int(k)))


def topk_compress(updates: dict, state: TopKState, *, frac: float = 0.01):
    """Returns (payload tree of ``(idx int32, vals f32)`` per leaf, new
    state).  The new error is a flat tree over the updates' layout."""
    frac = _check_frac(frac)
    layout = FlatLayout.of(updates)
    v = layout.flatten(updates).float() + layout.flatten(state.error).float()
    sent = torch.zeros_like(v)
    mag = v.abs()
    payload = {}
    for name, off, size in zip(layout.names, layout.offsets, layout.sizes):
        leaf = v[off:off + size]
        _, idx = torch.topk(mag[off:off + size], topk_k(size, frac))
        vals = leaf[idx]
        sent[off:off + size].index_put_((idx,), vals)
        payload[name] = (idx.to(torch.int32), vals)
    return payload, TopKState(error=layout.views(v - sent))


def topk_decompress(payload: dict, like_tree: dict) -> dict:
    """Rebuild dense updates from ``(idx, vals)`` payloads."""
    out = {}
    for name, (idx, vals) in payload.items():
        like = like_tree[name]
        dense = torch.zeros(like.numel(), dtype=torch.float32,
                            device=vals.device)
        dense.index_put_((idx.long(),), vals)
        out[name] = dense.reshape(like.shape).to(like.dtype)
    return out
