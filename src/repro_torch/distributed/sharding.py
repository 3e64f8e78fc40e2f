"""Worker and host shard maps of the mesh execution path — the pure-logic
part of ``repro/distributed/sharding.py`` (``WorkerShardMap``,
``HostShardMap``), copied.  The reference's ``ShardingRules`` and the
functions after it build JAX mesh ``PartitionSpec``s and stay out of the
port (ROADMAP M15).

A *shard* is the mesh path's unit of program dispatch and device placement:
workers map to shards by ``wid % n_shards``, so a worker keeps its shard
across elastic churn of other workers.  Devices here are ``torch.device``s
(:func:`repro_torch.launch.mesh.fl_shard_devices`).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["WorkerShardMap", "HostShardMap"]


@dataclass(frozen=True)
class WorkerShardMap:
    """Maps FL workers onto the mesh's worker shards.

    On one card every shard shares the device but still partitions the
    per-worker program dispatch and the shard-local merges.
    """

    n_shards: int
    shard_of_wid: dict       # wid -> shard index
    devices: tuple = ()      # shard -> torch.device ( () = engine device )

    @classmethod
    def build(cls, workers, n_shards: int, *, devices=None) -> "WorkerShardMap":
        """``workers``: WorkerInfo list (any order); ``devices``: optional
        shard->device list, cycled when shorter than ``n_shards``."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        mapping = {w.wid: w.wid % n_shards for w in workers}
        dev = ()
        if devices:
            dev = tuple(devices[s % len(devices)] for s in range(n_shards))
        return cls(n_shards=n_shards, shard_of_wid=mapping, devices=dev)

    def shard_of(self, wid: int) -> int:
        return self.shard_of_wid.get(wid, wid % self.n_shards)

    def device_for(self, wid: int):
        """The device worker ``wid``'s program runs on (None = the engine's
        device)."""
        if not self.devices:
            return None
        return self.devices[self.shard_of(wid)]

    def workers_in(self, shard: int) -> list:
        return sorted(w for w, s in self.shard_of_wid.items() if s == shard)

    def live_shards(self) -> set:
        """Shards with at least one live worker."""
        return set(self.shard_of_wid.values())

    def merge_groups(self) -> dict:
        """The hierarchical-combine topology (``combine_mode="tree"``):
        shard → its live workers in dispatch (wid) order."""
        return {s: self.workers_in(s) for s in sorted(self.live_shards())}


@dataclass(frozen=True)
class HostShardMap:
    """Partitions the K mesh shards into H contiguous host blocks — the host
    level of the combine hierarchy (``EngineConfig.hosts``).

    Host ``h`` owns shards ``[h*B, (h+1)*B)`` with ``B = n_shards //
    n_hosts``.  With ``B`` a power of two the blocks are aligned subtrees of
    the canonical pairwise tree (:meth:`pairwise_reduce`), so every host
    count computes the same nodes in the same order: ``hosts=H`` is
    bit-identical to ``hosts=1``.  Dead shards stay in the slot list as
    ``None`` holes, so the tree shape never depends on which shards live.
    """

    n_hosts: int
    n_shards: int

    @classmethod
    def build(cls, n_shards: int, n_hosts: int) -> "HostShardMap":
        if n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if n_shards % n_hosts != 0:
            raise ValueError(
                f"n_shards ({n_shards}) must be divisible by n_hosts "
                f"({n_hosts}): host blocks are equal contiguous shard "
                "ranges")
        block = n_shards // n_hosts
        if n_hosts >= 2 and block & (block - 1):
            raise ValueError(
                f"shards-per-host ({block}) must be a power of two for "
                f"hosts >= 2: only aligned pow2 blocks are exact subtrees "
                "of the canonical pairwise reduction, which is what makes "
                "results bit-identical across host counts")
        return cls(n_hosts=n_hosts, n_shards=n_shards)

    @property
    def block(self) -> int:
        """Shards per host."""
        return self.n_shards // self.n_hosts

    def host_of(self, shard: int) -> int:
        return shard // self.block

    def shards_of(self, host: int) -> range:
        return range(host * self.block, (host + 1) * self.block)

    @staticmethod
    def pairwise_reduce(slots: list, merge):
        """Canonical bottom-up pairwise reduction over positional slots.

        At each level, adjacent pairs ``(0,1), (2,3), ...`` merge; an odd
        trailing slot carries up unmerged.  ``None`` slots are holes: a
        hole merged with a value yields the value, two holes stay a hole.
        Returns the root slot (``None`` when every slot is a hole)."""
        if not slots:
            return None
        slots = list(slots)
        while len(slots) > 1:
            nxt = []
            for i in range(0, len(slots) - 1, 2):
                a, b = slots[i], slots[i + 1]
                if a is None:
                    nxt.append(b)
                elif b is None:
                    nxt.append(a)
                else:
                    nxt.append(merge(a, b))
            if len(slots) % 2:
                nxt.append(slots[-1])
            slots = nxt
        return slots[0]
