"""Client optimizers as pure functions over tensor dicts.

Port of ``repro/optim/optimizers.py``: ``opt.init(params) -> state``;
``opt.update(grads, state, params) -> (updates, state)``; apply with
:func:`apply_updates`.  The paper's SR/IC/TG clients use SGD with momentum
and weight decay (A.1).  ``adam``/``adamw`` serve only ``--task mlm`` and
are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

__all__ = ["Optimizer", "SGDState", "sgd", "apply_updates",
           "clip_by_global_norm"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def apply_updates(params: dict, updates: dict) -> dict:
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def clip_by_global_norm(grads: dict, max_norm: float, *, batch_dims: int = 0):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``.

    ``batch_dims`` leading dims index independent clients (the round's lane
    dim): each gets its own norm, as the reference computes it under vmap.
    Returns ``(clipped, gnorm)`` with ``gnorm`` of shape ``[batch...]``.
    """
    sq = None
    for k in sorted(grads):
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

