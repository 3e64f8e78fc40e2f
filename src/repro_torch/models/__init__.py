"""Models of the port: the paper's FL-task models (``papertasks``) and the
LM stack of the architecture zoo (``lm``: the dense family, and the ssm
family through the Mamba-2 mixer of ``ssd``)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

from .lm import (LayerKind, decode_step, forward, init_cache, init_params,
                 layer_plan, param_count, prefill)
from .papertasks import (TASK_MODELS, TaskModel, make_task_model,
                         params_from_numpy, params_to_numpy)

__all__ = ["TASK_MODELS", "TaskModel", "make_task_model", "params_from_numpy",
           "params_to_numpy", "init_params", "forward", "init_cache",
           "prefill", "decode_step", "layer_plan", "LayerKind",
           "param_count", "make_batch_spec", "lm_params_from_numpy",
           "lm_params_to_numpy"]


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
