"""Device-resident client batch cache (the round packer's hot set in device
memory) — port of ``repro/data/device_cache.py``.

Client datasets are static across rounds, yet a hot client re-sampled in
round t+k normally pays the host gather, the host scatter AND the full H2D
copy again for identical bytes.  With this cache the engine never uploads a
full ``[W, P, S, ...]`` batch buffer at all:

* the host gathers only the round's **miss** steps, as one compact
  ``[n_miss, b, ...]`` array per leaf (:func:`~repro_torch.data.batching
  .gather_content_rows`, into the pinned ring) — the only per-round
  content H2D;
* a persistent device-side **round base** per (W, P, S, leaf-signature)
  holds the assembled batches; three indexed writes, in place, recycle
  inserted clients' rows into the **pool** (an ``[R, b, ...]`` device
  tensor per leaf, R = ``capacity_rows``), write the miss rows at their
  slots, and fill **hit** clients' slots straight from the pool — hit
  content never touches the host or the bus;
* eviction is pure host bookkeeping (rows return to the free list).

Pool rows hold exactly the bytes the host path would have copied, so
training is bit-identical with the cache on or off.

The host half — :class:`CachePlan`, the shards, the LRU, :meth:`plan`,
:meth:`rebalance`, :meth:`invalidate`, the accounting — is the reference's,
line for line, so one plan sequence makes the same decisions in both
packages.  The device half differs where PyTorch does:

* **No donation.**  The reference donates the base and the pool into its
  jitted assembly; here they are written in place.  :meth:`apply` runs on
  the consumer thread, on the current stream, after the previous round's
  step was enqueued there, so stream order keeps the step's reads of a base
  ahead of the next round's writes into it.
* **Exact-length indices.**  The reference pads every index vector to a
  power of two with out-of-bounds sentinels that XLA drops
  (``mode="drop"``); ``index_copy_`` raises on the CPU and device-asserts
  on CUDA for such an index, so the port passes the exact vectors.  The
  reference's pow2 key is still counted through a
  :class:`~repro_torch.fl.round.StepCompileCache`, so ``stats()
  ["compiles"]`` means the same thing in both packages.
* **Zeros.**  Pools, bases and lazy pool growth are ``torch.zeros``:
  deterministic mode leaves ``torch.empty`` unfilled, and a masked step
  multiplies by the mask (NaN·0 is NaN).

Thread affinity (the engine's producer/consumer split): :meth:`plan`
mutates the LRU metadata and runs only on the pack (producer) thread, in
strict round order; :meth:`apply` touches the device tensors and runs only
on the consumer thread.

Sharded meshes (``n_shards > 1``, the engine's ``mesh_workers`` path): the
cache splits into **per-shard pools** — each mesh shard owns an equal slice
of the row budget, its own LRU, its own device pools (on that shard's
device), and its own round bases.  A client's rows live in the pool of the
shard its worker mapped to; hit/miss/bytes accounting is kept per shard and
sums to the global stats, and eviction in one pool never touches another.
Round bases are additionally keyed per worker *slot* within the shard, so
two workers of one shard never overwrite each other's live base inside a
round.  ``shard_for_client`` exposes where a client's rows currently live —
the input to the engine's cache-aware placement.

Orphan-shard reclamation (:meth:`rebalance`): a shard whose last worker
failed can serve nothing; the engine calls ``rebalance(live_shards)`` at the
top of every mesh round prep (producer thread, strict round order): dead
shards' entries are dropped and their *logical* budget is redistributed
over the survivors; when the shard comes back, survivors evict back down
and the budget returns.  The device pools never shrink and only grow lazily
on the consumer thread (``apply`` reads the plan-time snapshot
``CachePlan.pool_rows``, never the producer-owned live value).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["DeviceBatchCache", "CachePlan"]

_MAX_BASES = 4  # round bases kept per cache (distinct (W, P, S) shapes)


@torch.no_grad()
def _assemble_round(base, miss, pool, miss_dst, ins_src, ins_dst, hit_src,
                    hit_dst):
    """The reference's three indexed writes, in its order and in place:
    the pool insert from the miss rows, the miss scatter into the base, the
    hit scatter out of the *updated* pool.  Every destination is unique."""
    n_miss = int(miss_dst.shape[0])
    for name, b in base.items():
        rows = miss[name]
        flat = b.view((-1,) + tuple(rows.shape[1:]))
        p = pool[name]
        if ins_dst.numel():
            p.index_copy_(0, ins_dst, rows.index_select(0, ins_src))
        if n_miss:
            flat.index_copy_(0, miss_dst, rows[:n_miss])
        if hit_dst.numel():
            flat.index_copy_(0, hit_dst, p.index_select(0, hit_src))
    return base


def _row_signature(rows: dict) -> tuple:
    items = ((n, tuple(a.shape[1:]), str(a.dtype)) for n, a in rows.items())
    return tuple(sorted(items))


def _cat(parts: list) -> np.ndarray:
    if not parts:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(parts).astype(np.int64)


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _indices_on(device, *vectors) -> list:
    """The plan's index vectors on ``device`` in one copy (out of pinned
    memory on CUDA, so the consumer thread does not wait for the stream)."""
    sizes = [int(v.shape[0]) for v in vectors]
    host = torch.from_numpy(np.concatenate(vectors).astype(np.int64))
    if device.type == "cuda":
        host = host.pin_memory()
    return list(torch.split(host.to(device, non_blocking=True), sizes))


@dataclass
class _Entry:
    rows: np.ndarray  # [nb] pool row indices, ordered by batch_idx
    nb: int
    last_round: int


def _zero_totals() -> dict:
    return {
        "hit_steps": 0,
        "miss_steps": 0,
        "hit_clients": 0,
        "miss_clients": 0,
        "insertions": 0,
        "evictions": 0,
        "reclaim_evictions": 0,
        "bytes_saved": 0,
        "rounds": 0,
    }


@dataclass
class _Shard:
    """One mesh shard's slice of the cache: its own LRU, free list, device
    pools, round bases, and accounting.

    ``capacity`` is the LOGICAL row budget (producer-owned; rebalance moves
    it between shards); ``pool_rows`` is the PHYSICAL pool length
    (consumer-owned; set at pool allocation, grows lazily, never shrinks).
    After a shrink, entries may legally hold rows ``>= capacity`` — they
    stay valid (the pool still covers them) and age out of the LRU."""

    capacity: int
    device: object = None  # torch.device of the pool/bases (None = the
    #                        device the miss rows arrive on)
    entries: OrderedDict = field(default_factory=OrderedDict)  # cid -> _Entry
    free: list = field(default_factory=list)
    pools: dict | None = None
    pool_rows: int = 0  # physical pool length (0 = not allocated yet)
    bases: OrderedDict = field(default_factory=OrderedDict)
    totals: dict = field(default_factory=_zero_totals)
    max_slot: int = 0  # highest worker slot seen (scales the base LRU cap)

    def __post_init__(self):
        self.free = list(range(self.capacity - 1, -1, -1))

    def reset(self) -> None:
        self.entries.clear()
        self.free = list(range(self.capacity - 1, -1, -1))

    def rows_used(self) -> int:
        return sum(e.nb for e in self.entries.values())


@dataclass
class CachePlan:
    """One round's cache instructions, produced by :meth:`plan` on the pack
    thread and executed by :meth:`apply` on the consumer thread."""

    round_idx: int
    W: int
    P: int
    S: int
    content_mask: np.ndarray | None  # [N] bool: steps the host must gather
    n_miss_rows: int  # pow2 row count of the compact miss transfer
    miss_dst: np.ndarray  # [n_miss] flat round slots of the miss rows
    ins_src: np.ndarray  # [Ni] compact-miss row index to recycle
    ins_dst: np.ndarray  # [Ni] pool rows to write
    hit_src: np.ndarray  # [Nh] pool rows to read
    hit_dst: np.ndarray  # [Nh] flat round slots to fill
    hit_steps: int = 0
    miss_steps: int = 0
    hit_clients: int = 0
    miss_clients: int = 0
    inserted_clients: int = 0
    evicted_clients: int = 0
    bytes_saved: int = 0  # filled by apply() (needs leaf dtypes)
    shard: int = 0  # mesh shard whose pool serves this plan
    worker_slot: int = 0  # worker's slot within the shard (base isolation)
    pool_rows: int = 0  # shard's logical capacity at plan time: apply()
    #                     grows the physical pool to at least this, so the
    #                     consumer never reads the producer-owned live value

    @property
    def hit_rate(self) -> float:
        total = self.hit_steps + self.miss_steps
        return self.hit_steps / total if total else 0.0


class DeviceBatchCache:
    """LRU of hot clients' batch rows, resident in device memory.

    ``capacity_rows`` bounds the pool: exactly that many batch rows per
    leaf, allocated lazily on the first round.  Alternatively (or jointly —
    the tighter limit wins) ``capacity_bytes`` gives the budget in bytes;
    it is converted to rows via ``row_bytes``, the per-row byte footprint
    summed over the batch leaves (``--device-cache-mb`` in the train CLI;
    the engine probes one batch for it).  A client whose ``nb`` exceeds the
    capacity is never cached.  Entries are keyed by client id (with the
    round's ``nb`` validated on lookup — a mismatch is a miss); the batch
    leaf signature is global to the cache, and changing it under a live
    cache raises.  Up to ``_MAX_BASES`` persistent round bases are kept per
    worker slot; the least-recent is dropped beyond that.

    ``n_shards > 1`` splits the row budget into that many independent
    per-shard pools (mesh execution): every shard gets
    ``capacity_rows // n_shards`` rows, its own LRU and device tensors
    (placed on ``devices[shard]`` when given), and its own accounting —
    ``stats()['per_shard']`` sums to the global counters.
    """

    def __init__(
        self,
        capacity_rows: int = 0,
        *,
        capacity_bytes: int = 0,
        row_bytes: int = 0,
        compile_cache_size: int = 32,
        n_shards: int = 1,
        devices=None,
    ):
        # Deferred import: repro_torch.fl.round reaches back into
        # repro_torch.core (and from there repro_torch.data), so a
        # module-level import would cycle when ``repro_torch.data`` is the
        # entry point.
        from repro_torch.fl.round import StepCompileCache

        if capacity_rows <= 0 and capacity_bytes <= 0:
            raise ValueError(
                f"need a positive capacity_rows or capacity_bytes, got "
                f"rows={capacity_rows}, bytes={capacity_bytes}"
            )
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if capacity_bytes > 0:
            # Byte budget -> rows via the per-row footprint (the caller
            # probes one packed batch; see FederatedEngine).  When both
            # limits are given the tighter one wins.
            if row_bytes <= 0:
                raise ValueError(
                    f"capacity_bytes={capacity_bytes} needs the per-row size; "
                    f"got row_bytes={row_bytes}"
                )
            by_bytes = max(1, int(capacity_bytes) // int(row_bytes))
            capacity_rows = min(capacity_rows, by_bytes) if capacity_rows > 0 else by_bytes
        per_shard = int(capacity_rows) // int(n_shards)
        if per_shard < 1:
            raise ValueError(
                f"capacity of {capacity_rows} rows cannot be split over "
                f"{n_shards} shards (needs >= 1 row per shard)"
            )
        self.n_shards = int(n_shards)
        self.capacity_per_shard = per_shard
        # Effective total: the per-shard floor division is the capacity the
        # pools actually hold (a 10-row budget over 4 shards is 8 rows).
        self.capacity = per_shard * self.n_shards
        self.capacity_bytes = int(capacity_bytes)
        devices = list(devices) if devices else []
        self._shards = [
            _Shard(capacity=per_shard, device=devices[s] if s < len(devices) else None)
            for s in range(self.n_shards)
        ]
        self._rowsig: tuple | None = None
        self._row_bytes = 0
        self.rebalances = 0  # orphan-shard budget moves (see rebalance())
        self.rows_moved = 0  # logical capacity rows moved across shards
        # Optional observability hook (repro_torch.obs): when the engine
        # attaches a tracer, each producer-side plan() books a span on the
        # pack lane with its hit/miss outcome.  The LRU decisions are
        # identical with tracing on or off.
        self.tracer = None
        self._asm_cache = StepCompileCache(lambda: _assemble_round,
                                           capacity=compile_cache_size)

    # -- producer side (pack thread, strict round order) --------------------
    def plan(
        self, rplan, S: int, round_idx: int, *, shard: int = 0, worker_slot: int = 0
    ) -> CachePlan:
        """Decide hits/insertions/evictions for one round's :class:`RoundPlan`.

        Mutates only host-side LRU metadata; call from the pack thread, in
        round order.  ``S`` is the post-bucket stream length the round's
        device tensors will use (it defines the flat slot indices).
        ``shard`` picks the pool (the mesh path plans each worker's
        sub-plan against its shard); ``worker_slot`` isolates the worker's
        persistent round base from other workers of the same shard.
        """
        _t0 = time.perf_counter() if self.tracer is not None else 0.0
        sh = self._shards[shard]
        sh.max_slot = max(sh.max_slot, int(worker_slot))
        C = rplan.n_clients
        P = rplan.P
        flat_steps = (rplan.w_idx * P + rplan.p_idx) * S + rplan.s_idx  # [N]
        starts = np.cumsum(rplan.b_nb) - rplan.b_nb  # [C] plan-step offsets
        hit_sel = np.zeros(C, dtype=bool)
        hit_src: list[np.ndarray] = []
        hit_dst: list[np.ndarray] = []
        for i in range(C):
            cid, nb = int(rplan.b_cid[i]), int(rplan.b_nb[i])
            ent = sh.entries.get(cid)
            if ent is not None and ent.nb == nb:
                hit_sel[i] = True
                ent.last_round = round_idx
                sh.entries.move_to_end(cid)
                hit_src.append(ent.rows)
                hit_dst.append(flat_steps[starts[i] : starts[i] + nb])

        if C:
            step_hit = np.repeat(hit_sel, rplan.b_nb)
        else:
            step_hit = np.zeros(0, dtype=bool)
        n_hit_steps = int(step_hit.sum())
        miss_sel = ~step_hit
        comp_pos = np.cumsum(miss_sel) - 1  # plan step -> compact miss row

        ins_src: list[np.ndarray] = []
        ins_dst: list[np.ndarray] = []
        evicted = 0
        seen: set[int] = set()
        for i in np.flatnonzero(~hit_sel):
            cid, nb = int(rplan.b_cid[i]), int(rplan.b_nb[i])
            if cid in seen or nb > sh.capacity:
                continue
            seen.add(cid)
            stale = sh.entries.pop(cid, None)
            if stale is not None:
                # nb-mismatch re-insert: release the superseded entry's
                # rows first or they would leak from the pool forever.
                sh.free.extend(stale.rows.tolist())
                evicted += 1
            rows, ev = self._allocate(sh, nb, round_idx)
            evicted += ev
            if rows is None:
                continue  # every resident entry is already this round's
            sh.entries[cid] = _Entry(rows=rows, nb=nb, last_round=round_idx)
            ins_src.append(comp_pos[starts[i] : starts[i] + nb])
            ins_dst.append(rows)

        n_miss = int(rplan.n_steps_total - n_hit_steps)
        n_miss_rows = _pow2(max(n_miss, 1))
        miss_dst = flat_steps[miss_sel]
        if self.tracer is not None:
            self.tracer.add_span(
                "cache.plan",
                _t0,
                time.perf_counter() - _t0,
                round=int(round_idx),
                shard=int(shard),
                hit_steps=n_hit_steps,
                miss_steps=n_miss,
            )
        return CachePlan(
            round_idx=round_idx,
            W=rplan.W,
            P=P,
            S=S,
            content_mask=miss_sel if n_hit_steps else None,
            n_miss_rows=n_miss_rows,
            miss_dst=miss_dst,
            ins_src=_cat(ins_src),
            ins_dst=_cat(ins_dst),
            hit_src=_cat(hit_src),
            hit_dst=_cat(hit_dst),
            hit_steps=n_hit_steps,
            miss_steps=n_miss,
            hit_clients=int(hit_sel.sum()),
            miss_clients=int(C - hit_sel.sum()),
            inserted_clients=len(ins_dst),
            evicted_clients=evicted,
            shard=int(shard),
            worker_slot=int(worker_slot),
            pool_rows=sh.capacity,
        )

    @staticmethod
    def _allocate(sh: _Shard, nb: int, round_idx: int):
        """Take ``nb`` free rows from one shard, evicting its least-recent
        entries as needed.  Entries touched this round (hits and fresh
        inserts) are never evicted; returns (None, evicted) when only those
        remain."""
        evicted = 0
        while len(sh.free) < nb:
            cid, ent = next(iter(sh.entries.items()))
            if ent.last_round == round_idx:
                return None, evicted
            del sh.entries[cid]
            sh.free.extend(ent.rows.tolist())
            evicted += 1
        rows = np.asarray([sh.free.pop() for _ in range(nb)], dtype=np.int32)
        return rows, evicted

    # -- consumer side (device thread) --------------------------------------
    def apply(self, miss_rows: dict, cplan: CachePlan) -> dict:
        """Assemble the round's full device batches from compact miss rows.

        Writes the miss rows into the persistent round base, recycles
        inserted clients' rows into the pool, and fills hit slots from the
        pool, all in place on the current stream.  Returns the ``[W, P, S,
        ...]`` batches dict for the training step; it stays the cache's
        round base, which the next round of the same shape overwrites.
        """
        sh = self._shards[cplan.shard]
        rowsig = _row_signature(miss_rows)
        if self._rowsig is not None and rowsig != self._rowsig:
            msg = (
                "batch leaf signature changed under a live device cache; "
                f"cache holds {self._rowsig}, round needs {rowsig}"
            )
            raise RuntimeError(msg)
        if self._rowsig is None:
            self._rowsig = rowsig
            self._row_bytes = sum(
                int(np.prod(rows.shape[1:])) * rows.element_size()
                for rows in miss_rows.values()
            )
        if sh.device is None:
            sh.device = next(iter(miss_rows.values())).device
        if sh.pools is None:
            sh.pool_rows = max(cplan.pool_rows, 1)
            sh.pools = {
                name: self._device_zeros((sh.pool_rows,) + tuple(rows.shape[1:]), rows.dtype, sh)
                for name, rows in miss_rows.items()
            }
        elif cplan.pool_rows > sh.pool_rows:
            # Rebalance grew this shard's logical budget past the physical
            # pool: extend with zero rows (the plan only hands out row
            # indices below its snapshot, so growth always lands before the
            # first write that needs it — consumer thread, round order).
            extra = cplan.pool_rows - sh.pool_rows
            sh.pools = {
                name: torch.cat(
                    [pool, self._device_zeros((extra,) + tuple(pool.shape[1:]), pool.dtype, sh)]
                )
                for name, pool in sh.pools.items()
            }
            sh.pool_rows = cplan.pool_rows
        shape = (cplan.W, cplan.P, cplan.S)
        # Round bases are keyed per worker slot: two workers of one shard
        # must never pop (and overwrite) each other's live base in a round.
        base_key = (shape, rowsig, cplan.worker_slot)
        base = sh.bases.pop(base_key, None)
        if base is None:
            base = {
                name: self._device_zeros(shape + tuple(rows.shape[1:]), rows.dtype, sh)
                for name, rows in miss_rows.items()
            }
            max_bases = _MAX_BASES * (sh.max_slot + 1)
            while len(sh.bases) >= max_bases:
                sh.bases.popitem(last=False)
        # The reference's key: index lengths padded to powers of two.
        n_ins = _pow2(int(cplan.ins_src.shape[0])) if cplan.ins_src.size else 1
        n_hit = _pow2(int(cplan.hit_src.shape[0])) if cplan.hit_src.size else 1
        key = (shape, cplan.n_miss_rows, n_ins, n_hit, sh.pool_rows, rowsig)
        fn = self._asm_cache.lookup(key)
        idx = _indices_on(sh.device, cplan.miss_dst, cplan.ins_src,
                          cplan.ins_dst, cplan.hit_src, cplan.hit_dst)
        batches = fn(base, miss_rows, sh.pools, *idx)
        sh.bases[base_key] = batches
        cplan.bytes_saved = cplan.hit_steps * self._row_bytes
        t = sh.totals
        t["hit_steps"] += cplan.hit_steps
        t["miss_steps"] += cplan.miss_steps
        t["hit_clients"] += cplan.hit_clients
        t["miss_clients"] += cplan.miss_clients
        t["insertions"] += cplan.inserted_clients
        t["evictions"] += cplan.evicted_clients
        t["bytes_saved"] += cplan.bytes_saved
        t["rounds"] += 1
        return batches

    @staticmethod
    def _device_zeros(shape, dtype, sh: _Shard):
        """Zeros on the shard's device: never ``torch.empty``, whose bytes
        a masked step would multiply by zero (and NaN·0 is NaN)."""
        return torch.zeros(shape, dtype=dtype, device=sh.device)

    def retire_slots(self, shard: int, n_slots: int) -> None:
        """Drop round bases of worker slots beyond ``n_slots`` on one shard.

        Elastic churn can shrink a shard's worker set; the departed slots'
        bases are full ``[1, P, S, ...]`` device tensors that the slot-keyed
        LRU would otherwise retain for the rest of the run.  Consumer-thread
        call — bases are consumer-owned, like :meth:`apply`.
        """
        sh = self._shards[shard]
        for key in [k for k in sh.bases if k[2] >= n_slots]:
            del sh.bases[key]
        sh.max_slot = min(sh.max_slot, max(n_slots - 1, 0))

    def rebalance(self, live_shards) -> dict | None:
        """Redistribute the row budget over the shards that can execute.

        Producer-side (strict round order), called by the engine at the top
        of every mesh round prep.  Shards outside ``live_shards`` lost
        their last worker: their entries are dropped (nothing can hit them,
        and affinity must not be steered toward them) and their logical
        capacity moves to the survivors — deterministically, lowest live
        shard first for the remainder rows.  When a matching wid rejoins,
        the same call shrinks the survivors back (evicting least-recent
        entries over budget) and restores the shard's share.  Returns an
        event dict when capacities changed, else None.
        """
        if self.n_shards == 1:
            return None
        live = sorted({int(s) for s in live_shards if 0 <= int(s) < self.n_shards})
        if not live:
            return None
        base, rem = divmod(self.capacity, len(live))
        targets = [0] * self.n_shards
        for i, s in enumerate(live):
            targets[s] = base + (1 if i < rem else 0)
        current = [sh.capacity for sh in self._shards]
        if targets == current:
            return None
        evicted = 0
        for s, sh in enumerate(self._shards):
            if targets[s] != sh.capacity:
                evicted += self._resize_shard(sh, targets[s])
        moved = sum(max(0, c - t) for c, t in zip(current, targets))
        self.rebalances += 1
        self.rows_moved += moved
        return {
            "live_shards": live,
            "capacities": list(targets),
            "rows_moved": moved,
            "entries_evicted": evicted,
        }

    @staticmethod
    def _resize_shard(sh: _Shard, cap: int) -> int:
        """Set one shard's LOGICAL capacity; returns entries evicted.

        Shrink evicts least-recent entries until the held rows fit the new
        budget; surviving entries may keep row indices ``>= cap`` (the
        physical pool still covers them — it never shrinks), so the free
        list is rebuilt from the lowest unheld indices below ``cap``,
        keeping ``rows_used + len(free) == cap`` exact."""
        evicted = 0
        rows_used = sh.rows_used()
        while rows_used > cap:
            cid, ent = next(iter(sh.entries.items()))
            del sh.entries[cid]
            rows_used -= ent.nb
            evicted += 1
        used = {int(r) for e in sh.entries.values() for r in e.rows}
        avail = [r for r in range(cap) if r not in used][: cap - rows_used]
        sh.free = list(reversed(avail))  # pop() hands out the lowest row first
        sh.capacity = cap
        sh.totals["reclaim_evictions"] += evicted
        return evicted

    def invalidate(self) -> None:
        """Drop every cached entry and reset the free lists of every shard
        (pool/base device tensors stay allocated; their content becomes
        unreferenced).

        The engine calls this after a failed or aborted round prep — a
        prep that raised between :meth:`plan` and :meth:`apply` may have
        registered entries whose pool rows were never written, which a
        retry would serve as bogus hits — and on checkpoint restore."""
        for sh in self._shards:
            sh.reset()

    def shard_for_client(self, cid: int) -> int | None:
        """Which shard's pool currently holds ``cid``'s rows (None = not
        cached).  Producer-thread read — the input to cache-aware
        placement.  A cid duplicated across shards (possible under
        with-replacement sampling) reports the lowest shard."""
        for s, sh in enumerate(self._shards):
            if cid in sh.entries:
                return s
        return None

    # -- reporting ----------------------------------------------------------
    @property
    def totals(self) -> dict:
        """Global counters: the elementwise sum of the per-shard totals."""
        out = _zero_totals()
        for sh in self._shards:
            for k, v in sh.totals.items():
                out[k] += v
        return out

    @property
    def clients_cached(self) -> int:
        return sum(len(sh.entries) for sh in self._shards)

    @property
    def rows_used(self) -> int:
        return sum(sh.rows_used() for sh in self._shards)

    def _shard_stats(self, s: int) -> dict:
        sh = self._shards[s]
        out = dict(sh.totals)
        steps = out["hit_steps"] + out["miss_steps"]
        out["hit_rate"] = out["hit_steps"] / steps if steps else 0.0
        out["clients_cached"] = len(sh.entries)
        out["rows_used"] = sh.rows_used()
        out["capacity_rows"] = sh.capacity
        return out

    def stats(self) -> dict:
        out = dict(self.totals)
        steps = out["hit_steps"] + out["miss_steps"]
        out["hit_rate"] = out["hit_steps"] / steps if steps else 0.0
        out["clients_cached"] = self.clients_cached
        out["rows_used"] = self.rows_used
        out["capacity_rows"] = self.capacity
        out["capacity_bytes"] = self.capacity_bytes
        out["compiles"] = self._asm_cache.compiles
        if self.n_shards > 1:
            out["n_shards"] = self.n_shards
            out["rebalances"] = self.rebalances
            out["rows_moved"] = self.rows_moved
            out["per_shard"] = [self._shard_stats(s) for s in range(self.n_shards)]
        return out
