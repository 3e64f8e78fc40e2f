"""Round-batch construction: turn a placement Assignment into padded device
arrays for the round step.

A numpy-only copy of ``repro.data.batching`` (importing the reference would
load JAX); the one change is the allocator hook on :class:`PackBuffers`.

Execution model (the accelerator adaptation of Pollen's worker processes):

* each FL **worker** owns ``P`` parallel **lanes** (the concurrency level from
  the estimator — the analogue of multiple worker processes per GPU);
* each lane trains its assigned clients **sequentially as a stream of local
  steps**: client k's batches, then a *boundary* step where the trained model
  is folded into the worker's partial aggregate (Eq. 1) and parameters reset
  to the global model — then client k+1's batches, and so on;
* all lanes are padded to the longest stream ``S``.  Padded steps are masked
  (zero gradient, zero aggregation weight) — **pure waste**.

The makespan of lane streams is exactly the paper's straggler/idle-time
metric: LB placement balances predicted per-worker time, which here minimizes
``S`` and therefore the wasted padded steps.  ``padding_stats`` reports the
useful-compute fraction, which reappears in §Roofline as MODEL_FLOPS/HLO_FLOPs.

Packing is fully vectorized (the Pollen §3.2 lesson applied to the host side:
devices idle while the server prepares work is throughput lost): a
:class:`RoundPlan` computes every ``(w, p, s)`` slot index up front with
numpy, batch *content* arrives in one bulk ``dataset.gather_batches`` call,
and a single fancy-index scatter per array name fills buffers that are
allocated **directly at the S-bucketed size** (``s_align``) — no post-hoc
``np.pad`` recopy — and reused across rounds (:class:`PackBuffers`).  The
original per-batch loop packer survives as
:func:`build_round_arrays_loop`, the reference the vectorized path is
tested bit-identical against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["build_round_arrays", "build_round_arrays_loop", "RoundArrays",
           "RoundPlan", "PackBuffers", "plan_round", "padding_stats",
           "lane_split", "build_round_masks", "gather_content_rows",
           "split_plan_by_worker", "worker_stream_lengths"]


@dataclass
class RoundArrays:
    """Host-side numpy arrays for one round, ready for device_put.

    Leaf shapes: batches[name] = [W, P, S, b, ...]; masks = [W, P, S].
    """

    batches: dict            # name -> [W, P, S, b, ...]
    step_mask: np.ndarray    # [W, P, S] f32 — 1 for real local steps
    boundary: np.ndarray     # [W, P, S] f32 — 1 at a client's last step
    weight: np.ndarray       # [W, P, S] f32 — client weight at its boundary
    n_steps: int             # S (after any s_align bucketing)
    n_real_steps: int = 0    # longest real lane stream (pre-bucket S)

    def __post_init__(self):
        if not self.n_real_steps:
            self.n_real_steps = self.n_steps

    def useful_fraction(self) -> float:
        return float(self.step_mask.mean())


def lane_split(clients, n_lanes: int, *, steps_cap=None):
    """LPT-split one worker's client list across its P lanes.

    Returns (lanes, loads): lanes[p] = [(client, n_steps), ...].
    """
    lanes = [[] for _ in range(n_lanes)]
    loads = np.zeros(n_lanes, dtype=np.int64)
    for c in sorted(clients, key=lambda c: -c.n_batches):
        nb = c.n_batches if steps_cap is None else min(c.n_batches, steps_cap)
        p = int(np.argmin(loads))
        lanes[p].append((c, nb))
        loads[p] += nb
    return lanes, loads


@dataclass
class RoundPlan:
    """Every slot index of a round, computed up front (no content yet).

    Flat step arrays all have length N = total real local steps; boundary
    arrays have length = number of placed clients.
    """

    W: int
    P: int
    s_real: int                 # longest lane stream (pre-bucket S)
    w_idx: np.ndarray           # [N] worker row of each real step
    p_idx: np.ndarray           # [N] lane row
    s_idx: np.ndarray           # [N] stream position
    cids: np.ndarray            # [N] client id providing the step's batch
    batch_idx: np.ndarray       # [N] batch index within the client
    b_w: np.ndarray             # [C] boundary worker rows
    b_p: np.ndarray             # [C] boundary lane rows
    b_s: np.ndarray             # [C] boundary stream positions (last step)
    b_weight: np.ndarray        # [C] f32 client aggregation weights
    b_cid: np.ndarray           # [C] client id of each placed client
    b_nb: np.ndarray            # [C] steps (capped batches) of each client

    @property
    def n_steps_total(self) -> int:
        return int(self.w_idx.shape[0])

    @property
    def n_clients(self) -> int:
        return int(self.b_w.shape[0])


def plan_round(assignment, workers, *, lanes_per_worker: int = 1,
               steps_cap: int | None = None, min_steps: int = 1) -> RoundPlan:
    """Lane-split the assignment and vectorize the slot-index computation:
    one ``np.repeat``/``arange`` pass instead of a Python triple loop."""
    order = sorted(workers, key=lambda w: w.wid)
    W, P = len(order), lanes_per_worker

    # Per-client columns (Python loop is O(#clients), not O(#steps)).
    c_w, c_p, c_start, c_nb, c_cid, c_weight = [], [], [], [], [], []
    max_len = min_steps
    for wi, w in enumerate(order):
        lanes, loads = lane_split(assignment.per_worker.get(w.wid, []), P,
                                  steps_cap=steps_cap)
        for p, lane in enumerate(lanes):
            s = 0
            for c, nb in lane:
                c_w.append(wi)
                c_p.append(p)
                c_start.append(s)
                c_nb.append(nb)
                c_cid.append(c.cid)
                c_weight.append(float(c.weight))
                s += nb
            max_len = max(max_len, int(loads[p]))

    c_w = np.asarray(c_w, dtype=np.int64)
    c_p = np.asarray(c_p, dtype=np.int64)
    c_start = np.asarray(c_start, dtype=np.int64)
    c_nb = np.asarray(c_nb, dtype=np.int64)
    c_cid = np.asarray(c_cid, dtype=np.int64)
    c_weight = np.asarray(c_weight, dtype=np.float32)

    # Expand per-client columns to per-step rows.
    n = int(c_nb.sum()) if c_nb.size else 0
    flat_start = np.cumsum(c_nb) - c_nb          # flat offset of each client
    within = np.arange(n, dtype=np.int64) - np.repeat(flat_start, c_nb)
    return RoundPlan(
        W=W, P=P, s_real=int(max_len),
        w_idx=np.repeat(c_w, c_nb), p_idx=np.repeat(c_p, c_nb),
        s_idx=np.repeat(c_start, c_nb) + within,
        cids=np.repeat(c_cid, c_nb), batch_idx=within,
        b_w=c_w, b_p=c_p, b_s=c_start + c_nb - 1, b_weight=c_weight,
        b_cid=c_cid, b_nb=c_nb)


def split_plan_by_worker(plan: RoundPlan) -> list[RoundPlan]:
    """Partition a round's plan into one single-worker plan per worker row.

    The mesh execution path dispatches one device program per FL worker;
    each sub-plan describes that worker's ``[1, P, S, ...]`` block — same
    lane/stream coordinates, worker row collapsed to 0.  Steps and
    boundaries keep the parent plan's relative order (the parent is
    worker-major), so per-worker cache planning walks clients in the same
    order the fused plan would.  ``s_real`` stays the ROUND's longest lane:
    every worker program shares the round's bucketed S, which is what lets
    one compiled executable serve all workers.
    """
    out = []
    for wi in range(plan.W):
        sel = plan.w_idx == wi
        bsel = plan.b_w == wi
        out.append(RoundPlan(
            W=1, P=plan.P, s_real=plan.s_real,
            w_idx=np.zeros(int(sel.sum()), dtype=np.int64),
            p_idx=plan.p_idx[sel], s_idx=plan.s_idx[sel],
            cids=plan.cids[sel], batch_idx=plan.batch_idx[sel],
            b_w=np.zeros(int(bsel.sum()), dtype=np.int64),
            b_p=plan.b_p[bsel], b_s=plan.b_s[bsel],
            b_weight=plan.b_weight[bsel], b_cid=plan.b_cid[bsel],
            b_nb=plan.b_nb[bsel]))
    return out


def worker_stream_lengths(plan: RoundPlan) -> np.ndarray:
    """Per-worker real stream lengths ``[W]``: each worker row's longest
    lane fill (1 for an empty worker, mirroring ``plan_round``'s
    ``min_steps`` floor).  The mesh path's per-worker S bucketing
    (``EngineConfig.bucket_mode="worker"``) compiles each worker's program
    at its OWN bucketed length instead of the round's global ``s_real`` —
    this is where those lengths come from.  A lane's fill is its last
    boundary position + 1 (lanes fill contiguously from step 0)."""
    out = np.ones(plan.W, dtype=np.int64)
    if plan.n_clients:
        np.maximum.at(out, plan.b_w, plan.b_s + 1)
    return out


class PackBuffers:
    """Ring of reusable host-side pack buffers.

    ``depth`` slots per distinct (W, P, S, leaf-spec) key rotate round-robin:
    the pipelined engine needs ``pipeline_depth + 1`` so the background
    packer never writes the buffer whose device copy may still be in flight.
    Mask arrays are zeroed on reuse (cheap, [W, P, S]); batch arrays are left
    **stale** — every padded slot is masked out by ``step_mask`` in the
    compiled step, so their content never reaches the model update.
    """

    def __init__(self, depth: int = 2, *, alloc=np.zeros):
        self.depth = max(1, int(depth))
        # ``alloc(shape, dtype) -> zeroed ndarray``: the engine passes a
        # pinned-memory allocator on CUDA so the H2D copies run async.
        self._alloc = alloc
        self._rings: dict = {}   # key -> (slots list, cursor)
        # (batch_size, seq_len) -> [(name, row_shape, dtype)]: remembered
        # batch-leaf specs, so a round whose content is served entirely by
        # the device cache does not even probe the dataset for shapes.
        self.row_memo: dict = {}

    def acquire(self, W: int, S: int, mask_shape, leaf_specs):
        """Return (batches dict, step_mask, boundary, weight) buffers."""
        key = (W, S, tuple(mask_shape),
               tuple((n, tuple(sh), str(dt)) for n, sh, dt in leaf_specs))
        slots, cursor = self._rings.get(key, ([], 0))
        if len(slots) < self.depth:
            alloc = self._alloc
            slot = {
                "batches": {n: alloc(sh, dt) for n, sh, dt in leaf_specs},
                "step_mask": alloc(mask_shape, np.float32),
                "boundary": alloc(mask_shape, np.float32),
                "weight": alloc(mask_shape, np.float32),
            }
            slots.append(slot)
        else:
            slot = slots[cursor % self.depth]
            slot["step_mask"].fill(0.0)
            slot["boundary"].fill(0.0)
            slot["weight"].fill(0.0)
        self._rings[key] = (slots, (cursor + 1) % max(self.depth, 1))
        return (slot["batches"], slot["step_mask"], slot["boundary"],
                slot["weight"])


def _batch_content(dataset, cids, batch_idx, *, batch_size, seq_len) -> dict:
    """Bulk-fetch N batches; falls back to a per-batch loop for datasets
    (e.g. thin wrappers) that do not implement ``gather_batches``."""
    gather = getattr(dataset, "gather_batches", None)
    if gather is not None:
        return gather(cids, batch_idx, batch_size=batch_size, seq_len=seq_len)
    rows: dict[str, list] = {}
    for cid, bi in zip(cids.tolist(), batch_idx.tolist()):
        b = dataset.client_batch(cid, bi, batch_size=batch_size,
                                 seq_len=seq_len)
        for name, arr in b.items():
            rows.setdefault(name, []).append(np.asarray(arr))
    return {name: np.stack(v) for name, v in rows.items()}


def build_round_arrays(dataset, assignment=None, workers=None, *,
                       lanes_per_worker: int = 1,
                       steps_cap: int | None = None,
                       batch_size: int | None = None,
                       seq_len: int | None = None, min_steps: int = 1,
                       s_align=None,
                       buffers: PackBuffers | None = None,
                       plan: RoundPlan | None = None) -> RoundArrays:
    """Materialize padded [W, P, S, ...] stream arrays for an assignment.

    ``s_align``: optional ``f(s_real) -> S`` (e.g. the engine's s_bucket) —
    arrays are allocated at the aligned size directly, so no padding copy
    ever happens downstream.  ``buffers``: optional :class:`PackBuffers` to
    reuse host allocations across rounds.  ``plan``: optional precomputed
    :class:`RoundPlan`; when given, ``assignment``/``workers`` are ignored.
    (The engine's device-cache path does not use this full packer at all —
    see :func:`build_round_masks` + :func:`gather_content_rows`.)
    """
    if plan is None:
        plan = plan_round(assignment, workers,
                          lanes_per_worker=lanes_per_worker,
                          steps_cap=steps_cap, min_steps=min_steps)
    S = int(s_align(plan.s_real)) if s_align is not None else plan.s_real
    if S < plan.s_real:
        raise ValueError(f"s_align shrank S: {S} < {plan.s_real}")
    W, P = plan.W, plan.P

    row_specs = (buffers.row_memo.get((batch_size, seq_len))
                 if buffers is not None else None)
    if plan.n_steps_total:
        vals = _batch_content(dataset, plan.cids, plan.batch_idx,
                              batch_size=batch_size, seq_len=seq_len)
        row_specs = [(name, tuple(arr.shape[1:]), arr.dtype)
                     for name, arr in vals.items()]
    else:
        vals = {}
        if row_specs is None:   # probe one batch for leaf shapes/dtypes
            sample = dataset.client_batch(0, 0, batch_size=batch_size,
                                          seq_len=seq_len)
            row_specs = [(name, tuple(np.shape(arr)), np.asarray(arr).dtype)
                         for name, arr in sample.items()]
    if buffers is not None:
        buffers.row_memo[(batch_size, seq_len)] = row_specs
    leaf_specs = [(name, (W, P, S) + sh, dt) for name, sh, dt in row_specs]

    if buffers is not None:
        batches, step_mask, boundary, weight = buffers.acquire(
            W, S, (W, P, S), leaf_specs)
    else:
        batches = {n: np.zeros(sh, dt) for n, sh, dt in leaf_specs}
        step_mask = np.zeros((W, P, S), dtype=np.float32)
        boundary = np.zeros((W, P, S), dtype=np.float32)
        weight = np.zeros((W, P, S), dtype=np.float32)

    if plan.n_steps_total:
        idx = (plan.w_idx, plan.p_idx, plan.s_idx)
        for name, arr in vals.items():
            batches[name][idx] = arr
        step_mask[idx] = 1.0
        boundary[plan.b_w, plan.b_p, plan.b_s] = 1.0
        weight[plan.b_w, plan.b_p, plan.b_s] = plan.b_weight

    return RoundArrays(batches=batches, step_mask=step_mask, boundary=boundary,
                       weight=weight, n_steps=S, n_real_steps=plan.s_real)


def build_round_masks(plan: RoundPlan, S: int, *,
                      buffers: PackBuffers | None = None) -> RoundArrays:
    """Masks-only round arrays (``batches == {}``) for the device-cache
    path: batch *content* travels as compact miss rows
    (:func:`gather_content_rows`) and is assembled on device, so no
    full-size host batch buffer is ever allocated or transferred."""
    if S < plan.s_real:
        raise ValueError(f"S shrank below s_real: {S} < {plan.s_real}")
    W, P = plan.W, plan.P
    if buffers is not None:
        _, step_mask, boundary, weight = buffers.acquire(W, S, (W, P, S), [])
    else:
        step_mask = np.zeros((W, P, S), dtype=np.float32)
        boundary = np.zeros((W, P, S), dtype=np.float32)
        weight = np.zeros((W, P, S), dtype=np.float32)
    if plan.n_steps_total:
        step_mask[plan.w_idx, plan.p_idx, plan.s_idx] = 1.0
        boundary[plan.b_w, plan.b_p, plan.b_s] = 1.0
        weight[plan.b_w, plan.b_p, plan.b_s] = plan.b_weight
    return RoundArrays(batches={}, step_mask=step_mask, boundary=boundary,
                       weight=weight, n_steps=S, n_real_steps=plan.s_real)


def gather_content_rows(dataset, plan: RoundPlan, sel, n_rows: int, *,
                        batch_size: int | None = None,
                        seq_len: int | None = None,
                        buffers: PackBuffers | None = None) -> dict:
    """Compact ``{name: [n_rows, ...]}`` content for the selected steps.

    ``sel``: bool [N] step mask (None = every step); rows keep plan-step
    order.  The request is padded host-side to exactly ``n_rows`` (cids 0 /
    batch 0) BEFORE hitting the dataset, so the bulk-gather jit sees the
    same pow2-bucketed shape the caller's scatter uses — round-to-round
    variation in the selected count never compiles a new gather program.
    Padding rows carry dummy content; the device-side scatter drops them
    via out-of-bounds destinations.  With ``buffers``, leaf shapes for an
    all-padding result come from ``row_memo`` instead of a dataset probe.
    """
    cids = plan.cids if sel is None else plan.cids[sel]
    bidx = plan.batch_idx if sel is None else plan.batch_idx[sel]
    if cids.size > n_rows:
        raise ValueError(f"{cids.size} selected steps exceed n_rows={n_rows}")
    row_specs = (buffers.row_memo.get((batch_size, seq_len))
                 if buffers is not None else None)
    if cids.size:
        pad = n_rows - cids.size
        if pad:
            cids = np.concatenate([cids, np.zeros(pad, cids.dtype)])
            bidx = np.concatenate([bidx, np.zeros(pad, bidx.dtype)])
        out = _batch_content(dataset, cids, bidx,
                             batch_size=batch_size, seq_len=seq_len)
        row_specs = [(name, tuple(arr.shape[1:]), arr.dtype)
                     for name, arr in out.items()]
    else:
        if row_specs is None:
            sample = dataset.client_batch(0, 0, batch_size=batch_size,
                                          seq_len=seq_len)
            row_specs = [(name, tuple(np.shape(arr)), np.asarray(arr).dtype)
                         for name, arr in sample.items()]
        out = {name: np.zeros((n_rows,) + sh, dt)
               for name, sh, dt in row_specs}
    if buffers is not None:
        buffers.row_memo[(batch_size, seq_len)] = row_specs
    return out


def build_round_arrays_loop(dataset, assignment, workers, *,
                            lanes_per_worker: int = 1,
                            steps_cap: int | None = None,
                            batch_size: int | None = None,
                            seq_len: int | None = None,
                            min_steps: int = 1) -> RoundArrays:
    """Reference per-batch loop packer (the pre-vectorization implementation).

    Kept for the bit-identity property test and as the readable spec of what
    :func:`build_round_arrays` computes.
    """
    order = sorted(workers, key=lambda w: w.wid)
    W, P = len(order), lanes_per_worker

    streams: dict[tuple[int, int], list] = {}
    max_len = min_steps
    for wi, w in enumerate(order):
        lanes, loads = lane_split(assignment.per_worker.get(w.wid, []), P,
                                  steps_cap=steps_cap)
        for p, lane in enumerate(lanes):
            streams[(wi, p)] = lane
            max_len = max(max_len, int(loads[p]))
    S = int(max_len)

    sample = dataset.client_batch(0, 0, batch_size=batch_size, seq_len=seq_len)
    batches = {name: np.zeros((W, P, S) + tuple(np.shape(arr)),
                              np.asarray(arr).dtype)
               for name, arr in sample.items()}
    step_mask = np.zeros((W, P, S), dtype=np.float32)
    boundary = np.zeros((W, P, S), dtype=np.float32)
    weight = np.zeros((W, P, S), dtype=np.float32)

    for (wi, p), lane in streams.items():
        s = 0
        for c, nb in lane:
            for bi in range(nb):
                b = dataset.client_batch(c.cid, bi, batch_size=batch_size,
                                         seq_len=seq_len)
                for name, arr in b.items():
                    batches[name][wi, p, s] = np.asarray(arr)
                step_mask[wi, p, s] = 1.0
                s += 1
            boundary[wi, p, s - 1] = 1.0       # fold this client at its last step
            weight[wi, p, s - 1] = float(c.weight)

    return RoundArrays(batches=batches, step_mask=step_mask, boundary=boundary,
                       weight=weight, n_steps=S)


def padding_stats(round_arrays: RoundArrays) -> dict:
    m = round_arrays.step_mask
    return {
        "useful_steps": int(m.sum()),
        "total_steps": int(m.size),
        "useful_fraction": float(m.mean()),
        "S": round_arrays.n_steps,
        "clients_folded": int(round_arrays.boundary.sum()),
    }
