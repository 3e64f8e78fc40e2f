"""Models of the port: the paper's FL-task models (``papertasks``) and the
LM stack of the architecture zoo (``lm``: the dense family, the ssm family
through the Mamba-2 mixer of ``ssd``, and the MoE and hybrid families
through the routed experts of ``layers``), with the loss functions the
federated round trains them through."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

from repro_torch.kernels.layout import unflatten_tree

from .lm import (LayerKind, decode_step, forward, init_cache, init_params,
                 layer_plan, loss_fn, param_count, prefill)
from .papertasks import (TASK_MODELS, TaskModel, make_task_model,
                         params_from_numpy, params_to_numpy)

__all__ = ["TASK_MODELS", "TaskModel", "make_task_model", "params_from_numpy",
           "params_to_numpy", "init_params", "forward", "init_cache",
           "prefill", "decode_step", "layer_plan", "LayerKind",
           "param_count", "loss_fn", "make_loss_fn", "make_lane_loss_fn",
           "make_batch_spec", "lm_params_from_numpy", "lm_params_to_numpy"]


def _device_of(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device


def make_loss_fn(cfg, *, mesh=None, specs=None):
    """Bind the arch config: ``loss(params, batch)`` of one model (the
    nested tree) -> scalar, as ``repro.models.make_loss_fn``.  It runs
    where the params lie; on ``mesh`` (with ``specs``, see
    :func:`~repro_torch.models.lm.loss_fn`) the params and the batch are
    a rank's shards."""

    def _loss(params, batch):
        return loss_fn(params, batch, cfg, device=_device_of(params),
                       mesh=mesh, specs=specs)

    return _loss


def make_lane_loss_fn(cfg, *, mesh=None, specs=None):
    """The LM loss in the round step's contract: lane-stacked flat params
    ``{path: [L, ...]}`` (paths as :func:`~repro_torch.kernels.layout
    .flatten_tree` joins them) and a batch ``{k: [L, b, ...]}`` -> per-lane
    losses ``[L]``, on the params' device.

    A loop over lanes, each through :func:`make_loss_fn`'s loss on its own
    slice, so each lane's numbers do not depend on how many lanes share
    the call (the fused and mesh paths run one lane in different company).
    ``unbind`` hands every lane its slices, and its backward stacks the
    lanes' gradients into one ``[L, ...]`` tensor per leaf.  ``mesh`` and
    ``specs`` go to :func:`make_loss_fn`."""
    one = make_loss_fn(cfg, mesh=mesh, specs=specs)

    def _lane_loss(params, batch):
        lanes = {k: v.unbind(0) for k, v in params.items()}
        n_lanes = len(next(iter(lanes.values())))
        return torch.stack([
            one(unflatten_tree({k: v[i] for k, v in lanes.items()}),
                {k: v[i] for k, v in batch.items()})
            for i in range(n_lanes)])

    return _lane_loss


def make_batch_spec(cfg, *, batch: int, seq_len: int):
    """Host-side shapes/dtypes of one training micro-batch for this arch,
    as ``repro.models.make_batch_spec``."""
    spec = {"tokens": ((batch, seq_len), np.int32)}
    if cfg.frontend == "patch":
        spec["patch_embed"] = ((batch, cfg.frontend_len,
                                cfg.resolved_frontend_dim), np.float32)
    if cfg.frontend == "audio":
        spec["frames"] = ((batch, cfg.frontend_len, cfg.d_model), np.float32)
    return spec


def lm_params_from_numpy(tree, device=None):
    """The reference's nested parameter dict (numpy leaves) as the port's
    (tensors on ``device``: ``cuda`` unless ``device="cpu"`` is passed).

    The reference's bf16 leaves come out of ``np.asarray`` as
    ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses; they
    cross as their 16 bits (a ``uint16`` view) and are viewed back as
    ``torch.bfloat16``, so every value is carried exactly."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def lm_params_to_numpy(tree):
    """Inverse of :func:`lm_params_from_numpy`.  bf16 tensors come back as
    ``ml_dtypes.bfloat16`` arrays where that package is installed (it comes
    with JAX), else as f32 arrays holding the same values."""
    if isinstance(tree, dict):
        return {k: lm_params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        import ml_dtypes
    except ImportError:
        return t.float().numpy()
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
