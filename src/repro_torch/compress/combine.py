"""Compressed cross-shard combine: the wire format and its residual state —
port of ``repro/compress/combine.py``.

With ``EngineConfig.combine_compress != "none"`` each mesh shard's merged
partial is compressed before it crosses to the combine root.  What travels
is its DELTA from the global model (``theta_s - g``), through a per-shard
error-feedback residual:

    u_t   = (theta_s - g) + e_{t-1}
    sent  = C(u_t)                      # int8 round or top-k selection
    e_t   = u_t - dequant(sent)

so the compression error is delayed, never dropped.  The root rebuilds
``g + dequant(payload)`` inside the combine (K2 for int8).

All of it is f32 for every leaf, as in the reference: ``u``, the payload's
scales and the residuals live on the f32 twin of the params' layout
(:attr:`~repro_torch.kernels.layout.FlatLayout.twin`), whatever dtype each
leaf trains in.

Residuals live in one :class:`CombineCompressor` per engine and change at
one site, the consumer's mesh combine, in strict round order.  They ride a
checkpoint's ``.aux.npz`` sidecar (:meth:`CombineCompressor.state_aux`,
:meth:`~CombineCompressor.load_state`), params-shaped per shard as the
reference saves them, so a resumed compressed run is bitwise the
uninterrupted one.
"""

from __future__ import annotations

import math

import torch

from repro_torch.compress.quant import int8_quantize
from repro_torch.compress.topk import TopKState, topk_compress, topk_k
from repro_torch.kernels.layout import (FlatLayout, flatten_tree,
                                        unflatten_tree)

__all__ = ["CombineCompressor", "make_encode_step", "payload_nbytes"]


def payload_nbytes(like_params: dict, mode: str, frac: float = 0.05) -> int:
    """Wire bytes of ONE shard's compressed partial: per-leaf payload plus
    the exact weight and loss f32 scalars.

    * int8: 1 byte/elem + one f32 scale per leaf;
    * topk: k(leaf) × (4 B idx + 4 B val) per leaf.
    """
    sizes = [math.prod(tuple(x.shape)) for x in like_params.values()]
    if mode == "int8":
        body = sum(n + 4 for n in sizes)
    elif mode == "topk":
        body = sum(topk_k(n, frac) * 8 for n in sizes)
    else:
        raise ValueError(f"no payload for mode {mode!r}")
    return body + 8  # weight + loss f32 scalars


def make_encode_step(mode: str, frac: float):
    """The per-shard encoder
    ``encode(global_params, theta, residual) -> (payload, new_residual)``.

    ``theta`` is the shard's merged partial (params-shaped, in the params'
    dtypes), ``residual`` its carried error (the f32 twin).  The payload is
    ``(int8 tree, scales tree)`` or a tree of ``(idx, vals)`` per leaf, over
    the twin's layout."""
    if mode == "int8":

        def encode(global_params, theta, residual):
            layout = FlatLayout.of(global_params)
            twin = layout.twin
            u = (layout.to_twin(theta) - layout.to_twin(global_params)
                 + twin.flatten(residual))
            q, scales = int8_quantize(twin.views(u))
            new_res = u - q.flat.float() * twin.per_element(scales.flat)
            return (q, scales), twin.views(new_res)

        return encode
    if mode == "topk":

        def encode(global_params, theta, residual):
            layout = FlatLayout.of(global_params)
            delta = layout.to_twin(theta) - layout.to_twin(global_params)
            payload, state = topk_compress(layout.twin.views(delta),
                                           TopKState(residual), frac=frac)
            return payload, state.error

        return encode
    raise ValueError(f"no encode step for mode {mode!r}")


class CombineCompressor:
    """Owns the per-shard error-feedback residuals of the compressed
    combine (consumer-side state, strict round order) and the wire-format
    byte accounting."""

    def __init__(self, mode: str, like_params: dict, *,
                 topk_frac: float = 0.05):
        if mode not in ("int8", "topk"):
            raise ValueError(f"combine_compress mode must be int8|topk, got "
                             f"{mode!r}")
        self.mode = mode
        self.frac = float(topk_frac)
        self._layout = FlatLayout.of(like_params).twin
        self._device = next(iter(like_params.values())).device
        self.payload_bytes = payload_nbytes(like_params, mode, self.frac)
        self._residuals: dict[int, dict] = {}

    def residual(self, shard: int) -> dict:
        """The shard's carried error tree, the f32 twin of the params
        (zeros on first sight)."""
        r = self._residuals.get(shard)
        return self._zeros() if r is None else r

    def _zeros(self) -> dict:
        return self._layout.views(torch.zeros(
            self._layout.n, dtype=torch.float32, device=self._device))

    def commit(self, updates: dict) -> None:
        """Adopt this round's new residuals — once per round, after the
        combine is dispatched, so a failed round leaves the old set."""
        self._residuals.update(updates)

    def reset(self) -> None:
        self._residuals.clear()

    def residual_sq_sum(self) -> torch.Tensor:
        """Sum of squares over every shard's residual, as a device scalar
        (f64): reading it is the caller's host sync."""
        total = torch.zeros((), dtype=torch.float64, device=self._device)
        for tree in self._residuals.values():
            total = total + self._layout.flatten(tree).double().square().sum()
        return total

    def residual_norm(self) -> float:
        """Global L2 norm over every shard's residual (the error-feedback
        mass still waiting to be sent)."""
        return float(self.residual_sq_sum().sqrt())

    # -- checkpointing -------------------------------------------------------
    def state_meta(self) -> dict:
        """JSON-safe descriptor (the arrays ride the checkpoint's aux npz)."""
        return {"mode": self.mode, "frac": self.frac,
                "shards": sorted(int(s) for s in self._residuals)}

    def state_aux(self):
        """The residual trees keyed by shard id, each params-shaped (nested
        as the params are), or None when no shard has compressed yet."""
        if not self._residuals:
            return None
        return {f"s{int(s)}": unflatten_tree(self._residuals[s])
                for s in sorted(self._residuals)}

    def aux_like(self, shards) -> dict:
        """Structure template for :meth:`state_aux` of the given shard ids —
        what a checkpoint restore needs to load the npz back."""
        return {f"s{int(s)}": unflatten_tree(self._zeros()) for s in shards}

    def load_state(self, aux: dict) -> None:
        """Adopt residual trees read back from :meth:`state_aux`'s form."""
        layout = self._layout
        self._residuals = {
            int(key[1:]): layout.views(layout.flatten(
                {k: torch.as_tensor(v) for k, v in flatten_tree(tree).items()}
            ).to(self._device, torch.float32))
            for key, tree in aux.items()}
