"""Shard → device binding of the mesh execution path — port of
``repro/launch/mesh.py:49-98`` (``fl_shard_devices``,
``fl_combine_topology``).

Shard ``s`` runs on ``cuda:(s % device_count)``; the combine root is shard
0's device.  On one card every shard and the root are ``cuda:0``, as in the
reference's single-device case; an engine on the CPU maps every shard to
the CPU.  The reference's TPU mesh constructors have no counterpart here.
"""

from __future__ import annotations

import torch

__all__ = ["fl_shard_devices", "fl_combine_topology"]


def fl_shard_devices(n_shards: int, device="cuda") -> list:
    """One device per shard, cycled over the cards of ``device``'s type."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_shards
    count = torch.cuda.device_count()
    return [torch.device("cuda", s % count) for s in range(n_shards)]


def fl_combine_topology(n_shards: int, device="cuda") -> tuple:
    """``(shard_devices, root)``: shard ``s``'s merge runs on
    ``shard_devices[s]``, where its partials already live; the cross-shard
    combine runs on ``root`` (shard 0's device)."""
    devs = fl_shard_devices(n_shards, device)
    return devs, devs[0]
