"""The model of the SR task (Pollen, arXiv:2306.17453, §5.1: Speech
Recognition) as this repository defines it, written out plainly: a ReLU
stem ``input_dim -> width``, ``n_blocks`` residual blocks ``h = relu(h +
relu(h W1) W2)``, and a linear head to ``n_classes``; no biases; the mean
cross-entropy of a batch.  It is the repository's synthetic stand-in for
the paper's model (a ResNet-34 over audio), not that model.

Leaves and batches may carry a leading client dim; the loss is then one
mean per client.

Leaves: ``stem``, ``w1_<i>``, ``w2_<i>``, ``head``, all float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.lowp import matmul

__all__ = ["shapes", "loss", "STACK"]

STACK = 128        # clients the reference trains side by side (fl.py)


def shapes(cfg: dict) -> dict:
    """``{leaf: shape}`` at the configuration's sizes."""
    d, w = cfg["input_dim"], cfg["width"]
    out = {"stem": (d, w)}
    for i in range(cfg["n_blocks"]):
        out[f"w1_{i}"] = (w, w)
        out[f"w2_{i}"] = (w, w)
    out["head"] = (w, cfg["n_classes"])
    return out


def loss(p: dict, batch: dict, cfg: dict, q=None) -> torch.Tensor:
    h = torch.relu(matmul(batch["x"], p["stem"], q))
    for i in range(cfg["n_blocks"]):
        z = matmul(torch.relu(matmul(h, p[f"w1_{i}"], q)), p[f"w2_{i}"], q)
        h = torch.relu(h + z)
    logits = matmul(h, p["head"], q).float()
    y = batch["y"]
    ce = F.cross_entropy(logits.flatten(0, -2), y.flatten(),
                         reduction="none")
    return ce.view(y.shape).mean(-1)
