"""Picklable engine builders for the port's process-per-host tests: the
port's ``build_engine`` with the SR model cut to ``width=64, n_blocks=2``,
or with an LM arch's reduced config, on one intra-op thread, so a spawned
rank starts and trains in seconds.

It imports only ``repro_torch``: each spawned rank imports this module by
name (the parent's ``sys.path`` travels with the spawn), and loading JAX
there would only cost time.
"""

import torch

from repro_torch.launch import train

SMALL_SR = dict(width=64, n_blocks=2)


def build_small_sr_engine(**kw):
    """``train.build_engine(**kw)`` with the SR model at ``SMALL_SR``."""
    torch.set_num_threads(1)
    full = train.make_task_model

    def small(task, seed, *, device=None):
        return full(task, seed, device=device, **SMALL_SR)

    train.make_task_model = small
    try:
        return train.build_engine(**kw)
    finally:
        train.make_task_model = full


def build_small_lm_engine(arch: str, dtype: str, **kw):
    """``train.build_engine(lm_cfg=..., **kw)`` with ``arch``'s reduced
    config in ``dtype`` (a config does not pickle: it is built here)."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    torch.set_num_threads(1)
    cfg = replace(get_arch(arch).reduced(), dtype=dtype)
    return train.build_engine(lm_cfg=cfg, **kw)
