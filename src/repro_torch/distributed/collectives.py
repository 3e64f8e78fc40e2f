"""Collectives over one axis of a :class:`~repro_torch.launch.mesh.Mesh` —
the port's counterparts of ``jax.lax.psum``, ``pmean``, ``all_gather`` and
``axis_index`` inside the reference's ``shard_map``.

Each is differentiable, with the gradient of the unsharded function under
one convention: a loss computed on every rank from a result replicated
over the axis counts once, and the ranks' parts of a loss computed from
their own shards of data add up.  So:

* ``psum``'s backward passes the cotangent through: its result is
  replicated, and each rank's cotangent already is the whole gradient
  (an all-reduce there would count the loss once per rank);
* ``pmean``'s divides it by the axis size;
* ``all_gather``'s sums the ranks' cotangents and keeps this rank's slice
  (a reduce-scatter, made of an all-reduce and a slice, since gloo has no
  reduce-scatter): each rank used the gathered tensor on its own data, as
  FSDP's weight gather does;
* ``all_gather(..., sum_grad=False)``'s keeps this rank's slice of its own
  cotangent, with no sum and no traffic: the variant for an axis whose
  ranks compute the same thing on the same data, where each rank's
  cotangent already is the whole gradient and a sum would count it once
  per rank;
* ``sum_grad`` is the identity, and its backward sums the cotangent over
  the axes it names: a tensor replicated over them that each rank used on
  its own data.

**The training rule.**  A rank of a training step computes each layer
whole on its slice of the batch: the batch is split over the plan's
*batch* axes and replicated over the others (``model``, and the *worker*
axes, whose ranks train other clients).  So a parameter shard's gradient
is summed over each batch axis, and over no other axis:
:func:`repro_torch.distributed.sharding.gather_leaf` with ``batch_axes=``
gathers over a batch axis with the summing ``all_gather``, over any other
axis with ``sum_grad=False``, and passes a leaf replicated over a batch
axis through ``sum_grad``.  The serve path and the expert-parallel
dispatch keep the summing convention above.

On a gloo mesh a CUDA tensor crosses through the host, and bf16 and f16
are summed in f32 and rounded once, as one sum of them on the card would
be.  On a meta mesh nothing is sent: each collective returns a meta tensor
of its result's shape and reports its wire bytes per rank to the counter
that :func:`counting` made active, by the ring formulas of the reference's
``roofline.py`` (an all-gather ``(g-1)/g`` of its result's bytes, an
all-reduce ``2 (g-1)/g`` of its operand's).
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

import torch

__all__ = ["psum", "pmean", "all_gather", "sum_grad", "axis_index",
           "Collective", "counting", "wire_bytes"]


@dataclass(frozen=True)
class Collective:
    """One collective a meta mesh recorded: its kind, the axis, the group
    size, the payload bytes and the wire bytes each rank sends."""

    kind: str
    axis: str
    group_size: int
    bytes: int
    wire_bytes: float


_SINK: contextvars.ContextVar = contextvars.ContextVar("collectives",
                                                      default=None)


@contextlib.contextmanager
def counting(sink):
    """Make ``sink(collective)`` the receiver of every collective a meta
    mesh runs inside the block."""
    token = _SINK.set(sink)
    try:
        yield
    finally:
        _SINK.reset(token)


def wire_bytes(kind: str, nbytes: int, g: int) -> float:
    """Ring-algorithm bytes each rank sends: all-gather ``nbytes`` (its
    result) × (g-1)/g, all-reduce 2 × ``nbytes`` × (g-1)/g."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    return nbytes * (g - 1) / g


def _record(kind: str, axis: str, g: int, nbytes: int) -> None:
    sink = _SINK.get()
    if sink is not None:
        sink(Collective(kind, axis, g, nbytes, wire_bytes(kind, nbytes, g)))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _wire_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float32 if t.dtype in (torch.bfloat16, torch.float16) \
        else t.dtype


def _host(shape, dtype, device) -> torch.Tensor:
    """An empty host buffer: pinned when the data comes from or goes to a
    card (PyTorch's caching host allocator reuses it)."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def _all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (a new tensor)."""
    g = mesh.axis_size(axis)
    if mesh.meta:
        _record("all-reduce", axis, g, _nbytes(x))
        return torch.empty_like(x)
    import torch.distributed as dist
    group = mesh.groups[axis]
    if mesh.backend == "gloo" and (x.device.type != "cpu"
                                   or x.dtype != _wire_dtype(x)):
        buf = _host(x.shape, _wire_dtype(x), x.device)
        buf.copy_(x)
        dist.all_reduce(buf, group=group)
        return buf.to(x.device, non_blocking=True).to(x.dtype)
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim``."""
    g = mesh.axis_size(axis)
    if mesh.meta:
        shape = list(x.shape)
        shape[dim] *= g
        out = x.new_empty(shape)
        _record("all-gather", axis, g, _nbytes(out))
        return out
    import torch.distributed as dist
    group = mesh.groups[axis]
    src = x.contiguous()
    if mesh.backend == "gloo" and src.device.type != "cpu":
        host = _host(src.shape, src.dtype, src.device)
        host.copy_(src)
        parts = [_host(src.shape, src.dtype, src.device) for _ in range(g)]
        dist.all_gather(parts, host, group=group)
        # Each part to the card as it is, the concatenation there.
        return torch.cat([p.to(x.device, non_blocking=True) for p in parts],
                         dim=dim)
    parts = [torch.empty_like(src) for _ in range(g)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, sum_grad):
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, x.shape[dim]
        ctx.sum_grad = sum_grad
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grad:
            g = _all_reduce(g, ctx.mesh, ctx.axis)
        i = ctx.mesh.axis_index(ctx.axis)
        # A slice of its own storage: the whole cotangent can be freed.
        return (g.narrow(ctx.dim, i * ctx.n, ctx.n).clone(
            memory_format=torch.contiguous_format), None, None, None, None)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for a in ctx.axes:
            g = _all_reduce(g, ctx.mesh, a)
        return g, None, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over the ranks along ``axis``; replicated result."""
    return _PSum.apply(x, mesh, axis)


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Mean over the ranks along ``axis``; replicated result."""
    return psum(x, mesh, axis) / mesh.axis_size(axis)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0, *,
               tiled: bool = True, sum_grad: bool = True) -> torch.Tensor:
    """The ranks' ``x`` along ``axis``, in rank order: concatenated on
    ``dim`` (``tiled``) or stacked on a new ``dim``.  The backward sums
    the ranks' cotangents, or with ``sum_grad=False`` keeps this rank's
    slice of its own (see the module's docstring)."""
    if not tiled:
        x = x.unsqueeze(dim)
    return _AllGather.apply(x, mesh, axis, dim, sum_grad)


def sum_grad(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` itself; its backward sums the cotangent over ``axes`` (those
    of one rank are skipped)."""
    axes = tuple(a for a in axes if mesh.axis_size(a) > 1)
    return _SumGrad.apply(x, mesh, axes) if axes else x


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (0 on a meta mesh)."""
    return mesh.axis_index(axis)
