"""Federated rounds written out plainly: every client of a round trains
from the global model on its own, and the server takes the weighted mean.

One round (FedAvg, McMahan et al. 2017; Pollen's client recipe):

* client ``c`` starts from the global model with a fresh optimizer and
  takes ``min(batches_c, steps_cap)`` steps over its batches ``0, 1, ...``:
  the gradient of the batch's mean loss, clipped to global norm
  ``grad_clip`` where one is given, then SGD with momentum ``mu`` and
  weight decay ``wd``: ``m = mu m + g + wd θ``, ``θ -= lr m``, each leaf
  and its momentum kept in the leaf's dtype;
* the new global model is ``Σ_c n_c θ_c / Σ_c n_c``, ``n_c`` the client's
  sample count, summed in float64 and rounded once to each leaf's dtype;
* the round's loss is the mean over every client step of the step's loss.

Clients that take the same number of steps train side by side, up to
``stack`` of them at a time: each leaf carries a leading client dim, and
the model's ``loss`` gives one loss per client, so each client's gradient
is its own (the gradient of the sum of independent losses).  ``stack=1``
trains them one by one.

``half_batch`` plants a fault for the controls: every step uses only the
first half of its batch rows, the mean taken over those.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.data import Traffic, local_steps

__all__ = ["run_rounds"]


def _batches(traffic: Traffic, cids: list, b: int, device,
             half: bool) -> dict:
    rows = [traffic.batch(c, b) for c in cids]
    out = {}
    for k in rows[0]:
        t = torch.from_numpy(np.stack([r[k] for r in rows])).to(device)
        out[k] = t[:, : t.shape[1] // 2] if half else t
    return out


def _per_client(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """``x [C]`` shaped to broadcast over leaves of ``ndim`` dims."""
    return x.view(-1, *([1] * (ndim - 1)))


def _train_clients(loss, theta0: dict, traffic: Traffic, cids: list, n: int,
                   opt: dict, device, q, half_batch) -> tuple[dict, float]:
    """Clients ``cids``, ``n`` steps each, side by side from ``theta0``:
    their models (leaves ``[C, ...]``) and the sum of their step losses."""
    C = len(cids)
    theta = {k: v.unsqueeze(0).repeat(C, *([1] * v.ndim))
             for k, v in theta0.items()}
    mom = {k: torch.zeros_like(v) for k, v in theta.items()}
    lr, mu = opt["lr"], opt.get("momentum", 0.0)
    wd, clip = opt.get("weight_decay", 0.0), opt.get("grad_clip")
    total = 0.0
    for b in range(n):
        leaves = {k: v.detach().requires_grad_() for k, v in theta.items()}
        per = loss(leaves, _batches(traffic, cids, b, device, half_batch), q)
        grads = dict(zip(leaves, torch.autograd.grad(
            per.sum(), list(leaves.values()))))
        total += float(per.detach().double().sum())
        if clip is not None:
            norm = torch.sqrt(sum(g.float().square().flatten(1).sum(1)
                                  for g in grads.values()))
            scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
            grads = {k: (g * _per_client(scale, g.ndim)).to(g.dtype)
                     for k, g in grads.items()}
        with torch.no_grad():
            for k, g in grads.items():
                if wd:
                    g = g + wd * theta[k].to(g.dtype)
                mom[k] = mu * mom[k] + g
                theta[k] = (theta[k] - lr * mom[k]).to(theta[k].dtype)
    return theta, total


def run_rounds(loss, theta0: dict, traffic: Traffic, *, rounds: int,
               mix: dict, opt: dict, steps_cap, device, q=None,
               half_batch: bool = False, stack: int = 1) -> dict:
    """The first ``rounds`` rounds from ``theta0`` (``{leaf: tensor}`` on
    ``device``) under the traffic file ``mix`` (its cohort and sampler);
    ``loss(params, batch, q)`` gives each client's batch loss ``[C]`` for
    leaves and batches stacked on a leading client dim.
    Returns ``{"losses": [per round], "thetas": [θ after each round]}``,
    the thetas on the host."""
    theta = {k: v.detach().clone() for k, v in theta0.items()}
    losses, thetas = [], []
    for cohort in traffic.cohorts(rounds, mix):
        by_steps: dict = {}
        for cid in (int(c) for c in cohort):
            by_steps.setdefault(local_steps(traffic, cid, steps_cap),
                                []).append(cid)
        loss_sum, steps, weight = 0.0, 0, 0
        acc = {k: torch.zeros(v.shape, dtype=torch.float64, device=v.device)
               for k, v in theta.items()}
        for n, cids in sorted(by_steps.items()):
            for i in range(0, len(cids), stack):
                chunk = cids[i:i + stack]
                th, total = _train_clients(loss, theta, traffic, chunk, n,
                                           opt, device, q, half_batch)
                w = torch.tensor([traffic.weight(c) for c in chunk],
                                 dtype=torch.float64, device=device)
                with torch.no_grad():
                    for k, v in th.items():
                        acc[k] += (v.double() * _per_client(w, v.ndim)).sum(0)
                weight += int(w.sum())
                loss_sum += total
                steps += n * len(chunk)
                del th
        theta = {k: (acc[k] / weight).to(v.dtype) for k, v in theta.items()}
        del acc
        losses.append(loss_sum / max(steps, 1))
        thetas.append({k: v.detach().cpu() for k, v in theta.items()})
    return {"losses": losses, "thetas": thetas}
