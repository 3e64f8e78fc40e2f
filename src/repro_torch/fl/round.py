"""The federated round as one function (paper Fig. 5b) — port of the fused
path of ``repro/fl/round.py``.

``make_round_step(loss_fn, optimizer)`` builds::

    round_step(global_params, batches, step_mask, boundary, weight)
        -> (new_global_params, RoundMetrics)

with ``batches`` a dict of ``[W, P, S, ...]`` tensors and the masks
``[W, P, S]`` f32, all on one device.

Where the reference vmaps a ``lax.scan`` over the ``(W, P)`` lane grid, the
port writes the ``L = W·P`` lanes out as a leading dim and the ``S`` local
steps as a Python loop:

* every lane's client parameters, optimizer state and running partial live
  in one flat ``[L, N]`` buffer each (``N`` = parameter count), so one
  launch of the K1 kernel folds every lane and every leaf per step; a tree
  of several dtypes (bf16 matrices beside f32 norms) keeps one ``[L, n_g]``
  buffer per dtype group (:class:`~repro_torch.kernels.layout.FlatLayout`),
  each in its own dtype as the reference keeps each leaf, and K1 folds
  each group once a step;
* the forward runs on per-leaf views of the flat parameters — batched GEMMs
  over the lane dim — and the backward of the *sum* of the lane losses
  gives every lane exactly its own gradient;
* masked (padded) steps multiply the update by 0 and keep the old optimizer
  state; at a client's *boundary* step the trained parameters fold into the
  lane's partial by Eq. 1 behind the bitwise-no-op select of
  ``repro/fl/round.py:113-124``, and the lane resets to the global model
  and a fresh optimizer state;
* the lane losses accumulate in step order, and the cross-lane loss is a
  strict left-to-right sum (:func:`_ordered_sum`), so the round's numbers
  depend on nothing but the inputs — which is what keeps them bit-identical
  across pipeline depths.

The mesh path decomposes the same round into one
:func:`make_worker_round_step` program per FL worker (the lane loop over
that worker's ``[1, P, S, ...]`` block, returning unreduced lane partials)
plus a combine: :func:`make_combine_step` (the fused step's tail on the
concatenated partials), or §3.3's hierarchy — a per-shard
:func:`make_shard_merge_step`, then the combine over one partial per
shard, or the canonical pairwise tree of :func:`make_host_node_merge_step`
over host blocks, or the compressed combine
(:func:`make_compressed_combine_step`, K2 for int8 payloads).  Trees pass
between these programs as dicts whose leaves are views of one flat buffer
per dtype group (:class:`~repro_torch.kernels.layout.FlatTree`), so each
program works on a few flat tensors, each in its own dtype, as the
reference maps over leaves each in its own.  The compression family
(encode, decode, the compressed combine) computes in f32 for every leaf,
as the reference does, on the layout's f32 twin; its result is cast back
to each leaf's dtype.

On a mesh of several ranks (:func:`make_round_step` with ``mesh=``) one
client is split over the ranks, as the reference's plan splits it: each
rank runs :func:`make_worker_round_step` on its own workers' lanes, its
slice of their batch and its shards of θ (the loss gathers each layer,
:func:`repro_torch.models.lm.loss_fn`), so the optimizer and K1 work on
the rank's shards; then the ranks' lane partials, weights and loss totals
are all-gathered over the worker axes, in worker-axis rank order, and
reduced by the one-process tail (:func:`_reduce_partials`) on the same
``[W·P, ...]`` operands.

Non-associative strategies (FedMedian) take the gather path instead:
:func:`make_gather_round_step` trains the same lanes and returns every
lane's model unreduced.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, NamedTuple

import torch

from repro_torch.core.aggregation import (PartialAggregate, partial_init,
                                          partial_merge, partial_update,
                                          tree_weighted_mean)
from repro_torch.distributed import collectives
from repro_torch.kernels import ops as kops
from repro_torch.kernels.layout import FlatLayout
from repro_torch.kernels.ref import fedavg_accum_ref
from repro_torch.optim.optimizers import apply_updates, clip_by_global_norm

__all__ = ["make_round_step", "make_gather_round_step",
           "make_worker_round_step", "make_combine_step",
           "make_shard_merge_step", "make_host_node_merge_step",
           "make_payload_decode_step", "make_compressed_combine_step",
           "RoundMetrics", "StepCompileCache", "round_shape_key"]


class RoundMetrics(NamedTuple):
    loss: Any            # masked mean loss over all real steps
    steps: Any           # number of real local steps executed
    clients: Any         # number of clients folded
    total_weight: Any    # sum of aggregation weights


def _tree_select(flag, a, b):
    """``where(flag, a, b)`` over matching trees (tensors, dicts, tuples);
    ``flag`` is ``[L]`` and selects per lane."""
    if torch.is_tensor(b):
        f = flag.reshape(flag.shape + (1,) * (b.ndim - flag.ndim))
        return torch.where(f, a.to(b.dtype), b)
    if isinstance(b, dict):
        return {k: _tree_select(flag, a[k], v) for k, v in b.items()}
    if isinstance(b, tuple):
        vals = [_tree_select(flag, x, y) for x, y in zip(a, b)]
        return type(b)(*vals) if hasattr(b, "_fields") else tuple(vals)
    raise TypeError(f"cannot select over {type(b).__name__}")


def _stack_state(state, lanes: int):
    """One model's optimizer state stacked over ``lanes`` lanes (as the
    reference's vmap sees it): every tensor gains a leading ``[L]`` dim, so
    Adam's scalar ``step`` becomes one count per lane."""
    if torch.is_tensor(state):
        return state.expand((lanes,) + tuple(state.shape))
    if isinstance(state, dict):
        return {k: _stack_state(v, lanes) for k, v in state.items()}
    if isinstance(state, tuple):
        vals = [_stack_state(v, lanes) for v in state]
        return type(state)(*vals) if hasattr(state, "_fields") else tuple(vals)
    raise TypeError(f"cannot stack {type(state).__name__}")


def _zero_state(optimizer, flats: dict):
    """``optimizer.init(flats)`` without its memory: every optimizer of
    :mod:`repro_torch.optim` starts from zeros, which the lane loop only
    reads (each update makes new tensors), so each state tensor is one zero
    viewed at the state's shape.  The state's structure comes from ``init``
    on meta tensors."""
    device = next(iter(flats.values())).device
    meta = optimizer.init({k: torch.empty_like(f, device="meta")
                           for k, f in flats.items()})

    def zero(x):
        if torch.is_tensor(x):
            return torch.zeros((), dtype=x.dtype, device=device).expand(
                x.shape)
        if isinstance(x, dict):
            return {k: zero(v) for k, v in x.items()}
        if isinstance(x, tuple):
            vals = [zero(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        raise TypeError(f"cannot zero {type(x).__name__}")

    return zero(meta)


def _local_step(loss_fn, optimizer, grad_clip, layout: FlatLayout, theta,
                opt_state, batch, m, norm_sq=None):
    """One local SGD/Adam step of every lane: ``theta`` (``{key: [L,
    n_g]}``, one buffer per dtype group) and its optimizer state advance
    where the step mask ``m [L]`` is set; a masked lane keeps both exactly.
    ``norm_sq(grads)``, where given, is the clip's squared global norm
    ``[L]`` of the leaves' gradients (a rank of a mesh holds shards).
    Returns ``(theta, opt_state, loss [L])``."""
    L = m.shape[0]
    leaves = {k: v.detach().requires_grad_()
              for k, v in layout.views(theta).items()}
    with torch.enable_grad():
        loss = loss_fn(leaves, batch)
        grads = torch.autograd.grad(loss.sum(),
                                    [leaves[k] for k in layout.names])
    grads = dict(zip(layout.names, grads))
    sq = None if grad_clip is None or norm_sq is None else norm_sq(grads)
    grads = layout.flatten_groups(grads, lead=(L,))
    if grad_clip is not None:
        grads, _ = clip_by_global_norm(grads, grad_clip, batch_dims=1, sq=sq)
    updates, new_opt = optimizer.update(grads, opt_state, theta)
    del grads
    mcol = m[:, None]
    # The mask is cast per buffer, as the reference casts it per leaf.  Each
    # name is rebound as soon as it is used, so that no more than one
    # update-sized buffer is alive beside the new momentum.
    updates = {k: u * mcol.to(u.dtype) for k, u in updates.items()}
    theta = apply_updates(theta, updates)
    # Masked steps keep the old optimizer state (exact no-op).
    return theta, _tree_select(m > 0, new_opt, opt_state), loss.detach()


def _make_lane_scan(loss_fn, optimizer, *, agg_impl: str = "kernel",
                    grad_clip: float | None = None, norm_sq=None):
    """All lanes' sequential client streams: S local steps, folding each
    client into its lane's running partial at its boundary.

    ``loss_fn(params, batch)`` must take lane-stacked params ``{k: [L, ...]}``
    and a batch ``{k: [L, b, ...]}`` and return per-lane losses ``[L]``.
    """

    @torch.no_grad()
    def lane_scan(layout: FlatLayout, global_flats, lane_batches, mask,
                  boundary, weight):
        L, S = mask.shape
        theta0 = {k: g.expand(L, -1) for k, g in global_flats.items()}
        theta = {k: t.clone() for k, t in theta0.items()}
        opt0 = _stack_state(_zero_state(optimizer, global_flats), L)
        opt_state = opt0
        partial = partial_init(theta, lanes=L)
        loss_sum = torch.zeros(L, dtype=torch.float32, device=mask.device)
        for s in range(S):
            m, bnd, w = mask[:, s], boundary[:, s], weight[:, s]
            theta, opt_state, loss = _local_step(
                loss_fn, optimizer, grad_clip, layout, theta, opt_state,
                {k: v[:, s] for k, v in lane_batches.items()}, m, norm_sq)
            # Fold the trained client at its boundary, behind a select that
            # keeps masked/padded steps BITWISE no-ops on the partial (Eq. 1
            # rescales by N/(N+0), which can flip the last bit).  The folded
            # partial lives only as the select's input: bound to a name it
            # would stay alive through the next step's forward and backward
            # (one more [L, n_g] buffer per group at the round's peak).
            nk = w * bnd
            partial = _tree_select(
                nk > 0, partial_update(partial, theta, nk, impl=agg_impl),
                partial)
            # Reset the lane to the global model for the next client.
            theta = _tree_select(bnd > 0, theta0, theta)
            opt_state = _tree_select(bnd > 0, opt0, opt_state)
            # Lane loss totals accumulate in step order.
            loss_sum = loss_sum + loss * m
        return partial, loss_sum

    return lane_scan


def make_round_step(loss_fn, optimizer, *, agg_impl: str = "kernel",
                    grad_clip: float | None = None, mesh=None,
                    worker_axes: tuple = (), specs: dict | None = None):
    """Build the federated round function (see the module docstring).

    ``agg_impl``: ``"kernel"`` folds with the hand-written K1 (the plain
    version on CPU tensors); ``"plain"`` is the reference's XLA variant.

    With ``mesh`` (of more than one rank) the round runs on this rank's
    blocks: the params are its shards under ``specs`` (the parameter specs
    of :func:`repro_torch.launch.plan.sharding_specs`, nested), the batches
    and masks its ``[W_r, P, S, ...]`` block of the workers over
    ``worker_axes``, and ``loss_fn`` the loss of a lane on those shards
    (:func:`repro_torch.models.make_lane_loss_fn` with the lane specs).
    It returns this rank's shards of the new global params and the whole
    round's metrics.  ``grad_clip`` clips each lane's gradient by its
    global norm over the ranks' shards (:func:`_mesh_norm_sq`).
    """
    if mesh is not None and mesh.size > 1:
        return _make_mesh_round_step(loss_fn, optimizer, agg_impl, mesh,
                                     worker_axes, specs, grad_clip)
    lane_scan = _make_lane_scan(loss_fn, optimizer, agg_impl=agg_impl,
                                grad_clip=grad_clip)

    @torch.no_grad()
    def round_step(global_params, batches, step_mask, boundary, weight):
        layout = FlatLayout.of(global_params)
        gflats = layout.flatten_groups(global_params)
        partial, lane_losses = _scan_lanes(lane_scan, layout, gflats,
                                           batches, step_mask, boundary,
                                           weight)
        new_flats, metrics = _reduce_partials(
            gflats, partial.theta, partial.weight, lane_losses, step_mask,
            boundary, weight)
        return layout.views(new_flats), metrics

    return round_step


# Columns of the group buffers reduced at a time on a mesh: the workers'
# gathered partials of one chunk hold at most this many elements.
MESH_REDUCE_ELEMS = 1 << 26


def _mesh_norm_sq(mesh, lane_specs: dict):
    """The squared global norm ``[L]`` of a lane's gradients from a rank's
    shards (``{path: [L, ...]}`` under ``lane_specs``): each leaf's sum of
    squares, summed over the axes that split it and counted once over
    those that replicate it (there every rank holds the whole gradient),
    as ``clip_by_global_norm`` over the whole leaves.  The leaves that one
    set of axes splits are summed together and reduced once."""
    from repro_torch.distributed.sharding import _entry_axes

    def norm_sq(grads: dict):
        parts: dict = {}
        for path, g in grads.items():
            axes = tuple(a for e in lane_specs[path] for a in _entry_axes(e)
                         if mesh.axis_size(a) > 1)
            s = g.float().square().sum(dim=tuple(range(1, g.ndim)))
            parts[axes] = s if axes not in parts else parts[axes] + s
        total = None
        for axes in sorted(parts):
            s = parts[axes]
            for a in axes:
                s = collectives.psum(s, mesh, a)
            total = s if total is None else total + s
        return total

    return norm_sq


def _make_mesh_round_step(loss_fn, optimizer, agg_impl, mesh, worker_axes,
                          specs, grad_clip=None):
    """:func:`make_round_step` on one rank of ``mesh``."""
    from repro_torch.distributed.sharding import (gather_leaf, shard_leaf,
                                                  split_axes, tree_paths)
    axes = tuple(a for a in worker_axes if mesh.axis_size(a) > 1)
    lane_specs = {path: split_axes(spec, axes)[0]
                  for path, spec in tree_paths(specs or {})}
    worker_step = make_worker_round_step(
        loss_fn, optimizer, agg_impl=agg_impl, grad_clip=grad_clip,
        norm_sq=_mesh_norm_sq(mesh, lane_specs))
    # Worker axes that also split a leaf: a lane holds that leaf gathered
    # over them (the per-chip workers hold whole clients).
    split = {path: split_axes(spec, axes)[1]
             for path, spec in tree_paths(specs or {})}
    split = {k: v for k, v in split.items() if any(e is not None for e in v)}
    workers = ((axes if len(axes) > 1 else axes[0]),) if axes else ()

    def over_workers(x):
        """``[W_r, ...]`` -> ``[W, ...]``, the workers in rank order."""
        return gather_leaf(x, workers, mesh)

    @torch.no_grad()
    def round_step(global_params, batches, step_mask, boundary, weight):
        layout = FlatLayout.of(global_params)
        lane = global_params
        if split:
            lane = {k: gather_leaf(v, split[k], mesh) if k in split else v
                    for k, v in global_params.items()}
        lane_layout = FlatLayout.of(lane)
        # One flat copy, which the worker step and the tail share.
        gflats = lane_layout.flatten_groups(lane)
        lane = lane_layout.views(gflats)
        theta_wp, n_wp, lane_losses = worker_step(lane, batches, step_mask,
                                                  boundary, weight)
        L_r = n_wp.numel()
        n_l = over_workers(n_wp).reshape(-1)
        new_flats, metrics = _reduce_partials(
            gflats, {k: t.reshape(L_r, -1) for k, t in theta_wp.flats.items()},
            n_l, over_workers(lane_losses), over_workers(step_mask),
            over_workers(boundary), None, lanes=over_workers,
            cols=max(1, MESH_REDUCE_ELEMS // n_l.numel()))
        new = lane_layout.views(new_flats)
        if split:
            new = layout.views(layout.flatten_groups(
                {k: shard_leaf(v, split[k], mesh) if k in split else v
                 for k, v in new.items()}))
        return new, metrics

    return round_step


def _scan_lanes(lane_scan, layout, gflats, batches, step_mask, boundary,
                weight):
    """Run ``lane_scan`` over a ``[W, P, S, ...]`` block as ``L = W·P``
    lanes from the global model's group buffers ``gflats``; returns what
    it returns (the fused scan: the lanes' partial, ``{key: [L, n_g]}``
    and ``[L]``, and their loss totals ``[L]``)."""
    W, P = step_mask.shape[:2]
    L = W * P

    def lanes(x):
        return x.reshape((L,) + tuple(x.shape[2:]))

    return lane_scan(layout, gflats,
                     {k: lanes(v) for k, v in batches.items()},
                     lanes(step_mask), lanes(boundary), lanes(weight))


def make_worker_round_step(loss_fn, optimizer, *, agg_impl: str = "kernel",
                           grad_clip: float | None = None, norm_sq=None):
    """One FL worker's half of the round (the mesh path): the lane loop
    over that worker's ``[W_k, P, S, ...]`` block, returning its
    *unreduced* lane partials.

    ``worker_step(global_params, batches, step_mask, boundary, weight) ->
    (theta_wp, n_wp, lane_losses)`` with leaves ``[W_k, P, ...]`` (views of
    one ``[W_k, P, n_g]`` buffer per dtype group), ``[W_k, P]`` and ``[W_k,
    P]``.  Each lane's numbers
    are the fused step's: the lane loop is shared, and on the card the
    batched GEMMs give every lane the same bits for any lane count from 2
    up (on an H100; ``chip_smoke.py``'s decomposition phase checks it).
    ``norm_sq``: see :func:`_local_step`.
    """
    lane_scan = _make_lane_scan(loss_fn, optimizer, agg_impl=agg_impl,
                                grad_clip=grad_clip, norm_sq=norm_sq)

    @torch.no_grad()
    def worker_step(global_params, batches, step_mask, boundary, weight):
        W, P = step_mask.shape[:2]
        layout = FlatLayout.of(global_params)
        partial, lane_losses = _scan_lanes(
            lane_scan, layout, layout.flatten_groups(global_params),
            batches, step_mask, boundary, weight)
        theta = layout.views({k: t.reshape(W, P, -1)
                              for k, t in partial.theta.items()})
        return theta, partial.weight.reshape(W, P), lane_losses.reshape(W, P)

    return worker_step


def make_combine_step():
    """The round's server half on the mesh path: reduce the concatenated
    per-worker lane partials into the new global model + metrics.

    ``combine(global_params, theta_wp, n_wp, lane_losses, step_mask,
    boundary, weight) -> (new_global, metrics)`` — exactly the fused step's
    tail (:func:`_reduce_partials`) on the same ``[W·P, n_g]`` buffers,
    which is what keeps the flat mesh combine bitwise equal to the fused
    step.  Partials decoded from compressed payloads (the host hierarchy)
    come as the f32 twin: their mean is taken in f32 and cast back to each
    leaf's dtype, as the reference's ``m_.astype(g.dtype)`` does."""

    @torch.no_grad()
    def combine(global_params, theta_wp, n_wp, lane_losses, step_mask,
                boundary, weight):
        layout = FlatLayout.of(global_params)
        W, P = n_wp.shape
        tlay = FlatLayout.of(theta_wp, lead=2)
        theta = {k: t.reshape(W * P, -1)
                 for k, t in tlay.flatten_groups(theta_wp, (W, P)).items()}
        new_flats, metrics = _reduce_partials(
            layout.flatten_groups(global_params), theta, n_wp.reshape(-1),
            lane_losses, step_mask, boundary, weight,
            twin_of=layout if tlay != layout else None)
        return layout.views(new_flats), metrics

    return combine


def make_shard_merge_step():
    """One mesh shard's half of the hierarchical combine (§3.3's per-node
    partial merge, ``combine_mode="tree"``).

    ``merge(theta_wp, n_wp, lane_losses) -> (theta, n, loss)`` folds a
    shard's ``[W_s, P, ...]`` lane partials into one ``[1, 1, ...]``
    partial by :func:`partial_merge`, left to right in dispatch order, and
    sums the lane loss totals in the same order.  Each dtype group merges
    in its own dtype, as the reference merges each leaf in its own.  The grouping
    re-associates the cross-lane mean: tree losses match the flat combine
    to float tolerance, not bitwise."""

    @torch.no_grad()
    def merge(theta_wp, n_wp, lane_losses):
        layout = FlatLayout.of(theta_wp, lead=n_wp.ndim)
        flats = {k: f.reshape(-1, f.shape[-1]) for k, f in
                 layout.flatten_groups(theta_wp, tuple(n_wp.shape)).items()}
        flat_n = n_wp.reshape(-1)
        flat_loss = lane_losses.reshape(-1)
        acc = partial_init({k: f[0] for k, f in flats.items()})
        loss_sum = torch.zeros((), dtype=flat_loss.dtype,
                               device=flat_loss.device)
        for i in range(flat_n.shape[0]):
            acc = partial_merge(acc, PartialAggregate(
                {k: f[i] for k, f in flats.items()}, flat_n[i]))
            loss_sum = loss_sum + flat_loss[i]
        theta = layout.views({k: t.reshape(1, 1, -1)
                              for k, t in acc.theta.items()})
        return theta, acc.weight.reshape(1, 1), loss_sum.reshape(1, 1)

    return merge


def make_host_node_merge_step():
    """One node of the canonical pairwise combine tree (``hosts >= 1``;
    see :class:`~repro_torch.distributed.sharding.HostShardMap`).

    ``node(theta_a, n_a, loss_a, theta_b, n_b, loss_b) -> (theta, n,
    loss)`` merges two params-shaped partials by Eq. 1's weighted mean and
    adds their loss totals.  Every level of the tree runs this one
    function, so the result's bits depend on the tree's shape alone."""

    @torch.no_grad()
    def node(theta_a, n_a, loss_a, theta_b, n_b, loss_b):
        layout = FlatLayout.of(theta_a)
        merged = partial_merge(
            PartialAggregate(layout.flatten_groups(theta_a), n_a),
            PartialAggregate(layout.flatten_groups(theta_b), n_b))
        return layout.views(merged.theta), merged.weight, loss_a + loss_b

    return node


def _topk_delta(layout: FlatLayout, payload: dict, gf, k=None):
    """The dense f32 ``[N]`` delta a topk payload carries over the f32
    twin ``layout`` (shard ``k`` of a stacked payload when ``k`` is
    given): its ``(idx, vals)`` pairs scattered per leaf."""
    delta = torch.zeros_like(gf)
    for name, off, size in zip(layout.names, layout.offsets, layout.sizes):
        idx, vals = payload[name]
        if k is not None:
            idx, vals = idx[k], vals[k]
        delta[off:off + size].index_put_((idx.long(),), vals)
    return delta


def make_payload_decode_step(mode: str):
    """Per-shard payload reconstruction for the host-hierarchy combine
    (``hosts >= 1`` with ``combine_compress != "none"``).

    ``decode(global_params, payload) -> dense f32 params tree`` (the f32
    twin of the params' layout) rebuilds the shard's partial ``g +
    dequant(payload)`` as a dense tree the pairwise nodes can merge.  Plain
    PyTorch, as the reference computes it outside any Pallas kernel."""
    if mode not in ("int8", "topk"):
        raise ValueError(f"no decode step for mode {mode!r}")

    @torch.no_grad()
    def decode(global_params, payload):
        layout = FlatLayout.of(global_params)
        twin = layout.twin
        gf = layout.to_twin(global_params)
        if mode == "int8":
            q, scales = payload
            delta = (twin.flatten(q).float()
                     * twin.per_element(twin.scalars().flatten(scales)))
        else:
            delta = _topk_delta(twin, payload, gf)
        return twin.views(gf + delta)

    return decode


def make_compressed_combine_step(mode: str):
    """The cross-shard combine over COMPRESSED shard partials
    (``EngineConfig.combine_compress = "int8" | "topk"``).

    ``combine(global_params, payload, n_stack, loss_stack, step_mask,
    boundary, weight) -> (new_global, metrics)`` folds the K shard payloads
    left to right (dispatch order) into a running Eq. 1 accumulator, each
    reconstructed as ``g + dequant(payload_k)``:

        acc <- (acc*N + (g + dequant(payload_k))*n_k) / (N + n_k)

    The fold runs on the f32 twin of the params' layout, over every leaf
    of every dtype, and the result is cast back to each leaf's dtype.
    With ``mode="int8"`` each fold is ONE launch of the hand-written K2
    over the shard's whole flat payload (the plain version only on CPU
    tensors).  ``topk`` payloads scatter into a dense delta and blend in
    plain PyTorch, as the reference computes them outside any Pallas
    kernel.

    ``payload``: leaves stacked ``[K, ...]`` across shards — ``(int8 tree,
    scales tree)`` for int8, a tree of ``(idx, vals)`` per leaf for topk.
    ``n_stack``/``loss_stack``: ``[K]`` per-shard weights and loss totals,
    exact (scalars never compress)."""
    if mode not in ("int8", "topk"):
        raise ValueError(f"combine_compress mode must be int8|topk, got "
                         f"{mode!r}")

    @torch.no_grad()
    def combine(global_params, payload, n_stack, loss_stack, step_mask,
                boundary, weight):
        layout = FlatLayout.of(global_params)
        twin = layout.twin
        gflats = layout.flatten_groups(global_params)
        gf = layout.to_twin(global_params)
        K = n_stack.shape[0]
        acc = torch.zeros_like(gf)
        total_w = torch.zeros((), dtype=torch.float32, device=gf.device)
        if mode == "int8":
            q, scales = payload
            qf = twin.flatten(q, (K,))
            sf = twin.scalars().flatten(scales, (K,))
            offsets = twin.offsets_on(gf.device)
        for k in range(K):
            n_k = n_stack[k]
            if mode == "int8":
                acc = kops.dequant_merge_flat(acc, qf[k], gf, sf[k], offsets,
                                              total_w, n_k)
            else:
                acc = fedavg_accum_ref(
                    acc, gf + _topk_delta(twin, payload, gf, k), total_w,
                    n_k)
            total_w = total_w + n_k
        new_flats = {k: torch.where(total_w > 0, a, gflats[k])
                     for k, a in layout.from_twin(acc).items()}
        n_steps = step_mask.sum()
        metrics = RoundMetrics(
            loss=_ordered_sum(loss_stack) / torch.clamp(n_steps, min=1.0),
            steps=n_steps, clients=boundary.sum(), total_weight=total_w)
        return layout.views(new_flats), metrics

    return combine


def make_gather_round_step(loss_fn, optimizer, *,
                           grad_clip: float | None = None):
    """Round step for NON-associative strategies (paper §3.3 last
    paragraph): every lane returns its trained model and the server reduces
    them in one shot (FedMedian).  No kernel runs here: nothing folds.

    ``round_step(global_params, batches, step_mask, boundary, weight) ->
    (stacked, weights [W·P], metrics)``: the lanes' trained models as
    ``{key: [W·P, n_g]}``, one buffer per dtype group of the params'
    :class:`FlatLayout`, each lane's weight ``(boundary · weight).sum()``, and the round metrics; the caller
    applies the strategy's reduce.

    As in the reference (``repro/fl/round.py:471-512``), a lane is NOT
    reset at a client boundary: a lane that holds several clients trains
    them in sequence on one model and one optimizer state, and a lane with
    no client returns the global model, which still enters the reduce.
    """

    @torch.no_grad()
    def gather_scan(layout, global_flats, lane_batches, mask, boundary,
                    weight):
        L, S = mask.shape
        theta = {k: g.expand(L, -1).clone() for k, g in global_flats.items()}
        opt_state = _stack_state(optimizer.init(global_flats), L)
        loss_sum = torch.zeros(L, dtype=torch.float32, device=mask.device)
        for s in range(S):
            m = mask[:, s]
            theta, opt_state, loss = _local_step(
                loss_fn, optimizer, grad_clip, layout, theta, opt_state,
                {k: v[:, s] for k, v in lane_batches.items()}, m)
            loss_sum = loss_sum + loss * m
        return theta, (boundary * weight).sum(-1), loss_sum

    @torch.no_grad()
    def round_step(global_params, batches, step_mask, boundary, weight):
        layout = FlatLayout.of(global_params)
        thetas, ws, lane_losses = _scan_lanes(
            gather_scan, layout, layout.flatten_groups(global_params),
            batches, step_mask, boundary, weight)
        n_steps = step_mask.sum()
        metrics = RoundMetrics(
            loss=_ordered_sum(lane_losses) / torch.clamp(n_steps, min=1.0),
            steps=n_steps, clients=boundary.sum(), total_weight=ws.sum())
        return thetas, ws, metrics

    return round_step


def _ordered_sum(v):
    """Strict left-to-right sum: the association order is fixed by
    construction, whatever reduction tiling a library would pick."""
    flat = v.reshape(-1)
    acc = torch.zeros((), dtype=flat.dtype, device=flat.device)
    for i in range(flat.shape[0]):
        acc = acc + flat[i]
    return acc


def _reduce_partials(global_params, theta_l, n_l, lane_losses, step_mask,
                     boundary, weight, *, twin_of: FlatLayout | None = None,
                     cols: int | None = None, lanes=None):
    """The round's reduction tail: weighted mean of the lane partials
    (group buffers ``[L, n_g]``, weights ``[L]``) plus the round metrics.
    The mask and boundary sums add exact 0/1 floats and client weights are
    integer-valued, so only the loss sum needs a fixed order.  With
    ``twin_of``, ``theta_l`` is that layout's f32 twin ``{"flat": [L,
    N]}``, and its mean is cast back to the layout's group buffers.

    With ``cols`` (the mesh path) ``theta_l`` holds this rank's ``[L_r,
    n_g]`` lanes: the mean is taken ``cols`` columns at a time, each block
    first gathered by ``lanes`` into the one-process ``[L, cols]`` lane
    order.  A column's mean is its own, so the blocks give the whole
    buffer's bits."""
    total_w = n_l.sum()

    def kept(mean, g):
        # If the round somehow folded nothing, keep the old global model.
        return torch.where(total_w > 0, mean.to(g.dtype), g)

    if cols is None:
        mean = tree_weighted_mean(theta_l, n_l)
        if twin_of is not None:
            mean = twin_of.from_twin(mean["flat"])
        new_global = {k: kept(mean[k], g) for k, g in global_params.items()}
    else:
        new_global = {}
        for k, g in global_params.items():
            out = new_global[k] = torch.empty_like(g)
            for lo in range(0, g.shape[-1], cols):
                blk = slice(lo, lo + cols)
                mean = tree_weighted_mean({k: lanes(theta_l[k][:, blk])},
                                          n_l)
                out[blk] = kept(mean[k], g[blk])
    n_steps = step_mask.sum()
    metrics = RoundMetrics(
        loss=_ordered_sum(lane_losses) / torch.clamp(n_steps, min=1.0),
        steps=n_steps,
        clients=boundary.sum(),
        total_weight=total_w,
    )
    return new_global, metrics


def round_shape_key(batches, step_mask) -> tuple:
    """Cache key of a round's input signature: (W, P, S) plus every batch
    leaf's trailing shape/dtype."""
    W, P, S = step_mask.shape
    leaves = tuple(sorted((name, tuple(a.shape[3:]), str(a.dtype))
                          for name, a in batches.items()))
    return (W, P, S) + leaves


class StepCompileCache:
    """Counted LRU of round-step closures, keyed by input shape.

    The reference keeps jitted executables here.  Eager PyTorch compiles
    nothing, but the engine keeps the cache so that ``compiles`` (and
    ``RoundResult.recompiles``) still count the distinct round shapes a run
    met — the number S-bucketing keeps small — and old shapes are evicted.
    """

    def __init__(self, factory, *, capacity: int = 8):
        self._factory = factory          # () -> round_step fn
        self.capacity = max(1, int(capacity))
        self._entries: OrderedDict[tuple, Any] = OrderedDict()
        self.compiles = 0
        self.evictions = 0
        self.hits = 0
        # Optional tracer (repro_torch.obs): a fresh entry books an instant.
        self.tracer = None
        self.trace_label = "step"

    def lookup(self, key: tuple):
        """The step fn for ``key``, built (and counted) on a miss."""
        fn = self._entries.get(key)
        if fn is None:
            self.compiles += 1
            if self.tracer is not None:
                self.tracer.instant("compile", cache=self.trace_label,
                                    key=str(key))
            fn = self._factory()
            self._entries[key] = fn
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
                self.evictions += 1
        else:
            self.hits += 1
            self._entries.move_to_end(key)
        return fn

    def __call__(self, params, batches, step_mask, boundary, weight):
        fn = self.lookup(round_shape_key(batches, step_mask))
        return fn(params, batches, step_mask, boundary, weight)

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return {"compiles": self.compiles, "evictions": self.evictions,
                "hits": self.hits, "entries": len(self._entries)}
