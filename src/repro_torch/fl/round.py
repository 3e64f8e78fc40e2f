"""The federated round as one function (paper Fig. 5b) — port of the fused
path of ``repro/fl/round.py``.

``make_round_step(loss_fn, optimizer)`` builds::

    round_step(global_params, batches, step_mask, boundary, weight)
        -> (new_global_params, RoundMetrics)

with ``batches`` a dict of ``[W, P, S, ...]`` tensors and the masks
``[W, P, S]`` f32, all on one device.

Where the reference vmaps a ``lax.scan`` over the ``(W, P)`` lane grid, the
port writes the ``L = W·P`` lanes out as a leading dim and the ``S`` local
steps as a Python loop:

* every lane's client parameters, optimizer state and running partial live
  in one flat ``[L, N]`` buffer each (``N`` = parameter count), so one
  launch of the K1 kernel folds every lane and every leaf per step;
* the forward runs on per-leaf views of the flat parameters — batched GEMMs
  over the lane dim — and the backward of the *sum* of the lane losses
  gives every lane exactly its own gradient;
* masked (padded) steps multiply the update by 0 and keep the old optimizer
  state; at a client's *boundary* step the trained parameters fold into the
  lane's partial by Eq. 1 behind the bitwise-no-op select of
  ``repro/fl/round.py:113-124``, and the lane resets to the global model
  and a fresh optimizer state;
* the lane losses accumulate in step order, and the cross-lane loss is a
  strict left-to-right sum (:func:`_ordered_sum`), so the round's numbers
  depend on nothing but the inputs — which is what keeps them bit-identical
  across pipeline depths.

The mesh, gather, compressed-combine and host-merge programs of the
reference are not ported yet (ROADMAP M5, M12–M14).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, NamedTuple

import torch

from repro_torch.core.aggregation import (partial_init, partial_update,
                                          tree_weighted_mean)
from repro_torch.optim.optimizers import apply_updates, clip_by_global_norm

__all__ = ["make_round_step", "RoundMetrics", "StepCompileCache",
           "round_shape_key"]


class RoundMetrics(NamedTuple):
    loss: Any            # masked mean loss over all real steps
    steps: Any           # number of real local steps executed
    clients: Any         # number of clients folded
    total_weight: Any    # sum of aggregation weights


def _tree_select(flag, a, b):
    """``where(flag, a, b)`` over matching trees (tensors, dicts, tuples);
    ``flag`` is ``[L]`` and selects per lane."""
    if torch.is_tensor(b):
        f = flag.reshape(flag.shape + (1,) * (b.ndim - flag.ndim))
        return torch.where(f, a.to(b.dtype), b)
    if isinstance(b, dict):
        return {k: _tree_select(flag, a[k], v) for k, v in b.items()}
    if isinstance(b, tuple):
        vals = [_tree_select(flag, x, y) for x, y in zip(a, b)]
        return type(b)(*vals) if hasattr(b, "_fields") else tuple(vals)
    raise TypeError(f"cannot select over {type(b).__name__}")


class _FlatLayout:
    """A param dict laid out as one flat vector, leaves in sorted-name order
    (JAX's dict flattening order, so per-leaf sums keep the reference's
    association)."""

    def __init__(self, params: dict):
        self.names = sorted(params)
        self.shapes = [tuple(params[k].shape) for k in self.names]
        self.sizes = [math.prod(s) for s in self.shapes]
        dtypes = {params[k].dtype for k in self.names}
        if len(dtypes) != 1:
            raise TypeError(f"the round step needs one param dtype, got "
                            f"{sorted(map(str, dtypes))}")

    def flatten(self, tree: dict, lead: tuple = ()) -> torch.Tensor:
        """Leaves shaped ``lead + shape`` -> one ``lead + [N]`` tensor."""
        return torch.cat([tree[k].reshape(lead + (-1,)) for k in self.names],
                         dim=-1)

    def views(self, flat: torch.Tensor) -> dict:
        """``[..., N]`` -> ``{name: [..., *shape]}`` views (no copies)."""
        lead = tuple(flat.shape[:-1])
        out, off = {}, 0
        for k, shape, size in zip(self.names, self.shapes, self.sizes):
            out[k] = flat[..., off:off + size].view(lead + shape)
            off += size
        return out


def _make_lane_scan(loss_fn, optimizer, *, agg_impl: str = "kernel",
                    grad_clip: float | None = None):
    """All lanes' sequential client streams: S local steps, folding each
    client into its lane's running partial at its boundary.

    ``loss_fn(params, batch)`` must take lane-stacked params ``{k: [L, ...]}``
    and a batch ``{k: [L, b, ...]}`` and return per-lane losses ``[L]``.
    """

    @torch.no_grad()
    def lane_scan(layout: _FlatLayout, global_flat, lane_batches, mask,
                  boundary, weight):
        L, S = mask.shape
        theta0 = global_flat.expand(L, -1)
        theta = theta0.clone()
        opt0 = optimizer.init({"flat": theta})
        opt_state = opt0
        partial = partial_init({"flat": theta}, lanes=L)
        loss_sum = torch.zeros(L, dtype=torch.float32, device=theta.device)
        for s in range(S):
            batch = {k: v[:, s] for k, v in lane_batches.items()}
            m, bnd, w = mask[:, s], boundary[:, s], weight[:, s]
            leaves = {k: v.detach().requires_grad_()
                      for k, v in layout.views(theta).items()}
            with torch.enable_grad():
                loss = loss_fn(leaves, batch)
                grads = torch.autograd.grad(
                    loss.sum(), [leaves[k] for k in layout.names])
            grads = {"flat": layout.flatten(dict(zip(layout.names, grads)),
                                            lead=(L,))}
            if grad_clip is not None:
                grads, _ = clip_by_global_norm(grads, grad_clip, batch_dims=1)
            updates, new_opt = optimizer.update(grads, opt_state,
                                                {"flat": theta})
            mcol = m[:, None]
            theta = apply_updates(
                {"flat": theta},
                {k: u * mcol.to(u.dtype) for k, u in updates.items()})["flat"]
            # Masked steps keep the old optimizer state (exact no-op).
            opt_state = _tree_select(m > 0, new_opt, opt_state)
            # Fold the trained client at its boundary, behind a select that
            # keeps masked/padded steps BITWISE no-ops on the partial (Eq. 1
            # rescales by N/(N+0), which can flip the last bit).
            nk = w * bnd
            folded = partial_update(partial, {"flat": theta}, nk,
                                    impl=agg_impl)
            partial = _tree_select(nk > 0, folded, partial)
            # Reset the lane to the global model for the next client.
            theta = _tree_select(bnd > 0, theta0, theta)
            opt_state = _tree_select(bnd > 0, opt0, opt_state)
            # Lane loss totals accumulate in step order.
            loss_sum = loss_sum + loss.detach() * m
        return partial, loss_sum

    return lane_scan


def make_round_step(loss_fn, optimizer, *, agg_impl: str = "kernel",
                    grad_clip: float | None = None):
    """Build the federated round function (see the module docstring).

    ``agg_impl``: ``"kernel"`` folds with the hand-written K1 (the plain
    version on CPU tensors); ``"plain"`` is the reference's XLA variant.
    """
    lane_scan = _make_lane_scan(loss_fn, optimizer, agg_impl=agg_impl,
                                grad_clip=grad_clip)

    @torch.no_grad()
    def round_step(global_params, batches, step_mask, boundary, weight):
        W, P = step_mask.shape[:2]
        L = W * P
        layout = _FlatLayout(global_params)
        gflat = layout.flatten(global_params)

        def lanes(x):
            return x.reshape((L,) + tuple(x.shape[2:]))

        partial, lane_losses = lane_scan(
            layout, gflat, {k: lanes(v) for k, v in batches.items()},
            lanes(step_mask), lanes(boundary), lanes(weight))
        new_flat, metrics = _reduce_partials(
            {"flat": gflat}, partial.theta, partial.weight, lane_losses,
            step_mask, boundary, weight)
        return layout.views(new_flat["flat"]), metrics

    return round_step


def _ordered_sum(v):
    """Strict left-to-right sum: the association order is fixed by
    construction, whatever reduction tiling a library would pick."""
    flat = v.reshape(-1)
    acc = torch.zeros((), dtype=flat.dtype, device=flat.device)
    for i in range(flat.shape[0]):
        acc = acc + flat[i]
    return acc


def _reduce_partials(global_params, theta_l, n_l, lane_losses, step_mask,
                     boundary, weight):
    """The round's reduction tail: weighted mean of the lane partials
    (leaves ``[L, ...]``, weights ``[L]``) plus the round metrics.  The mask
    and boundary sums add exact 0/1 floats and client weights are
    integer-valued, so only the loss sum needs a fixed order."""
    total_w = n_l.sum()
    mean = tree_weighted_mean(theta_l, n_l)
    # If the round somehow folded nothing, keep the old global model.
    new_global = {k: torch.where(total_w > 0, mean[k].to(g.dtype), g)
                  for k, g in global_params.items()}
    n_steps = step_mask.sum()
    metrics = RoundMetrics(
        loss=_ordered_sum(lane_losses) / torch.clamp(n_steps, min=1.0),
        steps=n_steps,
        clients=boundary.sum(),
        total_weight=total_w,
    )
    return new_global, metrics


def round_shape_key(batches, step_mask) -> tuple:
    """Cache key of a round's input signature: (W, P, S) plus every batch
    leaf's trailing shape/dtype."""
    W, P, S = step_mask.shape
    leaves = tuple(sorted((name, tuple(a.shape[3:]), str(a.dtype))
                          for name, a in batches.items()))
    return (W, P, S) + leaves


class StepCompileCache:
    """Counted LRU of round-step closures, keyed by input shape.

    The reference keeps jitted executables here.  Eager PyTorch compiles
    nothing, but the engine keeps the cache so that ``compiles`` (and
    ``RoundResult.recompiles``) still count the distinct round shapes a run
    met — the number S-bucketing keeps small — and old shapes are evicted.
    """

    def __init__(self, factory, *, capacity: int = 8):
        self._factory = factory          # () -> round_step fn
        self.capacity = max(1, int(capacity))
        self._entries: OrderedDict[tuple, Any] = OrderedDict()
        self.compiles = 0
        self.evictions = 0
        self.hits = 0
        # Optional tracer (repro_torch.obs): a fresh entry books an instant.
        self.tracer = None
        self.trace_label = "step"

    def lookup(self, key: tuple):
        """The step fn for ``key``, built (and counted) on a miss."""
        fn = self._entries.get(key)
        if fn is None:
            self.compiles += 1
            if self.tracer is not None:
                self.tracer.instant("compile", cache=self.trace_label,
                                    key=str(key))
            fn = self._factory()
            self._entries[key] = fn
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
        else:
            self.hits += 1
            self._entries.move_to_end(key)
        return fn

    def __call__(self, params, batches, step_mask, boundary, weight):
        fn = self.lookup(round_shape_key(batches, step_mask))
        return fn(params, batches, step_mask, boundary, weight)

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return {"compiles": self.compiles, "evictions": self.evictions,
                "hits": self.hits, "entries": len(self._entries)}
