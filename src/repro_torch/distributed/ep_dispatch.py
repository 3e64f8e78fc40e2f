"""Expert-parallel MoE dispatch over a mesh of ranks — port of
``repro/distributed/ep_dispatch.py``.

With activations replicated over the ``model`` axis and experts split over
it, expert-parallel dispatch needs no token communication: rank (d, m)
already holds both its ``data`` shard of tokens and its ``model`` shard of
experts.

  1. each rank routes its local tokens against all experts, keeps only the
     slots that target its local experts, and builds ``[E_loc, C, D]``
     capacity buffers, all local;
  2. the expert products run on weights all-gathered over the FSDP axis;
  3. each rank adds its experts' outputs back into its local token frame
     ``[T_loc, D]``; one ``psum`` over ``model`` sums the k expert
     contributions that live on different ranks.

Capacity is per (data shard, expert): ``C = max(1, int(cf·k·T_loc/E))``
(an ``int``, as the reference computes it), so drops follow local routing.

The hook takes each rank's own shards: ``x3 [b_loc, s, D]`` (the batch
split over ``batch_axes``), the whole router ``[D, E]``, ``gate``/``up``
``[E_loc, D_fsdp, F]`` and ``down`` ``[E_loc, F, D_fsdp]`` (experts split
over ``model_axis``, ``D`` over ``fsdp_axis``).  Its gradients are those of
the reference's ``shard_map``: each input's cotangent is summed over the
axes its spec leaves out, each output's divided by their sizes, so the
gradient of a loss whose per-rank parts add up (each rank its tokens, a
replicated term once) is the unsharded function's, shard by shard.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.models import layers

__all__ = ["make_ep_dispatch"]


class _Leave(torch.autograd.Function):
    """Identity; the backward divides the cotangent by the sizes of
    ``axes`` (an output replicated over them)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _enter(x, mesh, axes):
    """Identity; the backward sums the cotangent over ``axes`` (an input
    replicated over them, used by every rank on its own part)."""
    return coll.sum_grad(x, mesh, axes)


def _leave(x, mesh, axes):
    n = math.prod(mesh.axis_size(a) for a in axes)
    return _Leave.apply(x, n) if n > 1 else x


def _psum(x, mesh, axis):
    """``jax.lax.psum`` inside ``shard_map``: its backward sums the
    cotangents too (outputs' cotangents come divided by :func:`_leave`)."""
    return coll.psum(_enter(x, mesh, (axis,)), mesh, axis)


def _local_moe(x, router_w, gate_w, up_w, down_w, *, top_k: int,
               capacity_factor: float, n_experts: int, mesh,
               model_axis: str, fsdp_axis: str | None):
    """Per-rank body. x ``[T_loc, D]``; gate/up ``[E_loc, D_loc, F]``;
    down ``[E_loc, F, D_loc]``.  ``(out [T_loc, D], aux)``."""
    E_loc = gate_w.shape[0]
    e0 = coll.axis_index(mesh, model_axis) * E_loc        # first local expert
    probs, gate_vals, gate_idx, C, pos = layers._route(
        x, router_w, top_k=top_k, capacity_factor=capacity_factor)
    if fsdp_axis is not None and mesh.axis_size(fsdp_axis) > 1:
        gate_w = coll.all_gather(gate_w, mesh, fsdp_axis, dim=1)
        up_w = coll.all_gather(up_w, mesh, fsdp_axis, dim=1)
        down_w = coll.all_gather(down_w, mesh, fsdp_axis, dim=2)
    out = layers._scatter_experts(x, gate_vals, gate_idx, pos, C, gate_w,
                                  up_w, down_w, e0=e0)
    out = _psum(out, mesh, model_axis)
    return out, layers._switch_aux(probs, gate_idx, n_experts)


def make_ep_dispatch(mesh, *, batch_axes=("data",), model_axis="model",
                     fsdp_axis="data", seq_chunk: int = 0):
    """Build the ``cfg.moe_dispatch`` hook: ``(x3 [b_loc, s, D], router,
    gate, up, down, top_k, capacity_factor) -> (out [b_loc, s, D], aux)``
    on this rank's shards of ``mesh``.

    ``seq_chunk`` > 0 runs the dispatch over sequence blocks (the tail
    zero-padded), the aux term averaged over them: jamba's 14,336-wide
    experts need it."""
    batch_axes = tuple(batch_axes or ())
    axes = tuple(mesh.axis_names)
    n_model = mesh.axis_size(model_axis)
    w_axes = {model_axis, fsdp_axis} - {None}
    x_free = tuple(a for a in axes if a not in batch_axes)
    w_free = tuple(a for a in axes if a not in w_axes)

    def run(x_blk, router_w, gate_w, up_w, down_w, top_k, capacity_factor):
        b, s, D = x_blk.shape
        E = router_w.shape[-1]
        xl = _enter(x_blk, mesh, x_free)
        rw = _enter(router_w, mesh, axes)
        gw, uw, dw = (_enter(w, mesh, w_free) for w in (gate_w, up_w,
                                                         down_w))
        out, aux = _local_moe(xl.reshape(b * s, D), rw, gw, uw, dw,
                              top_k=top_k, capacity_factor=capacity_factor,
                              n_experts=E, mesh=mesh, model_axis=model_axis,
                              fsdp_axis=fsdp_axis)
        for a in batch_axes:            # the mean over data shards
            aux = _psum(aux, mesh, a) / mesh.axis_size(a)
        return (_leave(out.reshape(b, s, D), mesh, x_free),
                _leave(aux, mesh, axes))

    def dispatch(x3, router_w, gate_w, up_w, down_w, *, top_k,
                 capacity_factor):
        E = router_w.shape[-1]
        if gate_w.shape[0] * n_model != E:
            raise ValueError(
                f"moe_dispatch expects this rank's {E // n_model} of {E} "
                f"experts (split over {model_axis!r}), got "
                f"{gate_w.shape[0]}")
        kw = dict(top_k=top_k, capacity_factor=capacity_factor)
        b, s_tot, D = x3.shape
        if not seq_chunk or s_tot <= seq_chunk:
            return run(x3, router_w, gate_w, up_w, down_w, **kw)
        pad = (-s_tot) % seq_chunk
        if pad:
            x3 = F.pad(x3, (0, 0, 0, pad))
        outs = []
        aux = torch.zeros((), dtype=torch.float32, device=x3.device)
        for xc in x3.split(seq_chunk, dim=1):
            out, a = run(xc, router_w, gate_w, up_w, down_w, **kw)
            outs.append(out)
            aux = aux + a
        return torch.cat(outs, dim=1)[:, :s_tot], aux / len(outs)

    # What the serve path reads to hand the hook its expert shards.
    dispatch.model_axis, dispatch.fsdp_axis = model_axis, fsdp_axis
    dispatch.seq_chunk = seq_chunk
    return dispatch
