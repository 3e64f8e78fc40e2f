"""Pollen on PyTorch and CUDA: the port of the ``repro`` package to an
NVIDIA H100.

The layout mirrors ``repro`` module for module (``repro/core/engine.py`` ↔
``repro_torch/core/engine.py``).  The port imports ``torch`` and numpy and
never JAX, nor anything of ``repro``: the numpy-only modules it needs are
copied.  Its entry points run on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless asked otherwise.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present — the port never carries on silently on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
