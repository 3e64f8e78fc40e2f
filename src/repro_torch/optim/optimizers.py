"""Client optimizers as pure functions over tensor dicts.

Port of ``repro/optim/optimizers.py``: ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (updates, state)``; apply with
:func:`apply_updates`.  The paper's SR/IC/TG clients use SGD with momentum
and weight decay, its MLM clients Adam (A.1); ``adamw`` is Adam with
decoupled weight decay.

``init`` gives the state of ONE model.  The round step trains ``L`` lanes
side by side and stacks that state ``L`` times (as the reference's vmap
does), so Adam's ``step`` counter becomes ``[L]``, one count per lane:
``update`` broadcasts ``step`` over the trailing dims of each leaf.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

__all__ = ["Optimizer", "SGDState", "AdamState", "sgd", "adam", "adamw",
           "make_optimizer", "apply_updates", "clip_by_global_norm"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def clip_by_global_norm(grads: dict, max_norm: float, *, batch_dims: int = 0,
                        sq=None):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``.

    ``batch_dims`` leading dims index independent clients (the round's lane
    dim): each gets its own norm, as the reference computes it under vmap.
    ``sq``, where given, is the squared norm ``[batch...]`` taken
    elsewhere (a rank of a mesh holds a shard of the gradients).
    Returns ``(clipped, gnorm)`` with ``gnorm`` of shape ``[batch...]``.
    """
    for k in sorted(grads) if sq is None else ():
        g = grads[k].float()
        s = g.square().sum(dim=tuple(range(batch_dims, g.ndim)))
        sq = s if sq is None else sq + s
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    def leaf(g):
        sc = scale.reshape(scale.shape + (1,) * (g.ndim - batch_dims))
        return (g * sc).to(g.dtype)

    return {k: leaf(g) for k, g in grads.items()}, gnorm


class SGDState(NamedTuple):
    momentum: Any


def sgd(lr: float, momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    """SGD + momentum + weight decay — paper A.1 client optimizer."""

    def init(params):
        if momentum == 0.0:
            return SGDState(momentum=())
        return SGDState(momentum={k: torch.zeros_like(p)
                                  for k, p in params.items()})

    def update(grads, state, params):
        if weight_decay:
            grads = {k: g + weight_decay * params[k].to(g.dtype)
                     for k, g in grads.items()}
        if momentum == 0.0:
            return {k: -lr * g for k, g in grads.items()}, state
        new_m = {k: momentum * state.momentum[k] + g for k, g in grads.items()}
        updates = {k: -lr * m for k, m in new_m.items()}
        return updates, SGDState(momentum=new_m)

    return Optimizer(init=init, update=update)



class AdamState(NamedTuple):
    step: Any            # int32 update count: () for one model, [L] stacked
    mu: Any
    nu: Any


def _per_lane(x: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``x`` (shaped like ``step``) broadcast over ``leaf``'s trailing dims."""
    return x.reshape(x.shape + (1,) * (leaf.ndim - x.ndim))


def _adam(lr, b1, b2, eps, weight_decay, decoupled) -> Optimizer:
    def init(params):
        first = next(iter(params.values()))
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            mu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()})

    def update(grads, state, params):
        if weight_decay and not decoupled:
            grads = {k: g + weight_decay * params[k].to(g.dtype)
                     for k, g in grads.items()}
        step = state.step + 1
        mu = {k: b1 * state.mu[k] + (1 - b1) * g.float()
              for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * torch.square(g.float())
              for k, g in grads.items()}
        bc1 = 1 - torch.pow(b1, step.float())
        bc2 = 1 - torch.pow(b2, step.float())

        def upd(m, v, p):
            u = (-lr * (m / _per_lane(bc1, m))
                 / (torch.sqrt(v / _per_lane(bc2, v)) + eps))
            if weight_decay and decoupled:
                u = u - lr * weight_decay * p.float()
            return u.to(p.dtype)

        updates = {k: upd(mu[k], nu[k], p) for k, p in params.items()}
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam with coupled (L2) weight decay — paper A.1's MLM optimizer."""
    return _adam(lr, b1, b2, eps, weight_decay, decoupled=False)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    """Adam with decoupled weight decay."""
    return _adam(lr, b1, b2, eps, weight_decay, decoupled=True)


def make_optimizer(name: str, **kw) -> Optimizer:
    name = name.lower()
    if name == "sgd":
        return sgd(**kw)
    if name == "adam":
        return adam(**kw)
    if name == "adamw":
        return adamw(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
