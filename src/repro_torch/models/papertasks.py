"""The paper's FL-task models (§5.1) — port of ``repro/models/papertasks.py``.

Only SR is ported: the ResNet-style residual MLP over audio features with
35 classes (Google Speech Commands).  IC, TG and MLM raise until a later
slice ports them (ROADMAP M3).

Models are plain functions of a param dict.  Every function also takes
*lane-stacked* inputs: params ``{k: [L, ...]}`` with a batch
``{"x": [L, b, d], "y": [L, b]}`` give per-lane losses ``[L]`` (the matmuls
become batched GEMMs), which is how the round step trains its lanes
side by side.  Unstacked inputs give a scalar, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.layers import dense_init

__all__ = ["TaskModel", "TASK_MODELS", "make_task_model", "sr_init",
           "sr_forward", "params_from_numpy", "params_to_numpy"]


def _xent(logits, labels):
    """Mean cross-entropy over the last batch dim.  The gold log-prob is
    picked with a one-hot product instead of ``gather``, whose backward is a
    scatter-add: the product keeps the backward elementwise and
    deterministic on the card."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (labels.long().unsqueeze(-1) == classes).to(logp.dtype)
    gold = (logp * onehot).sum(-1)
    return -gold.mean(-1)


# ---------------------------------------------------------------------------
# SR — ResNet-34-style residual MLP
# ---------------------------------------------------------------------------
def sr_init(gen: torch.Generator, *, input_dim=64, width=512, n_blocks=8,
            n_classes=35, dtype=torch.float32) -> dict:
    p = {"stem": dense_init(gen, (input_dim, width), dtype)}
    for i in range(n_blocks):
        p[f"w1_{i}"] = dense_init(gen, (width, width), dtype)
        p[f"w2_{i}"] = dense_init(gen, (width, width), dtype)
    p["head"] = dense_init(gen, (width, n_classes), dtype)
    return p


def sr_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    relu = torch.relu
    h = relu(x @ p["stem"])
    n_blocks = sum(1 for k in p if k.startswith("w1_"))
    for i in range(n_blocks):
        z = relu(h @ p[f"w1_{i}"]) @ p[f"w2_{i}"]
        h = relu(h + z)
    return h @ p["head"]


def _sr_loss(p, batch):
    return _xent(sr_forward(p, batch["x"]), batch["y"])


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TaskModel:
    name: str
    init: Callable
    loss_fn: Callable            # (params, batch) -> loss ([L] when stacked)


TASK_MODELS = {"sr": TaskModel("sr", sr_init, _sr_loss)}


def make_task_model(task: str, seed: int = 1337, *, device=None, **kw):
    """Returns (params, loss_fn) for a ported task, params on ``device``
    (``cuda`` unless ``device="cpu"`` is passed).

    The weights come from a ``torch.Generator`` seeded with ``seed``; they
    differ from the reference's ``jax.random`` init by design.  Tests that
    compare the two packages hand the reference's weights over with
    :func:`params_from_numpy`.
    """
    if task not in TASK_MODELS:
        raise NotImplementedError(
            f"task {task!r} is not ported yet (only 'sr'; ROADMAP M3)")
    tm = TASK_MODELS[task]
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    params = {k: v.to(device) for k, v in tm.init(gen, **kw).items()}
    return params, tm.loss_fn


def params_from_numpy(params: dict, device=None) -> dict:
    """``{name: ndarray}`` -> ``{name: Tensor}`` on ``device`` (copied;
    ``cuda`` unless ``device="cpu"`` is passed)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in params.items()}


def params_to_numpy(params: dict) -> dict:
    """Inverse of :func:`params_from_numpy`."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
