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
  its own data;
* ``reduce_scatter`` sums over the axis and keeps this rank's block of a
  dim; its backward all-gathers the blocks' cotangents;
* ``split`` keeps this rank's block of a dim, with no traffic; its
  backward all-gathers the blocks' cotangents.

These give Megatron's tensor-parallel operators: its "f" (identity
forward, all-reduce backward) is ``sum_grad``, its "g" (all-reduce
forward, identity backward) ``psum``; with the sequence split over the
axis (sequence parallelism), the entry of a split block is
``all_gather`` over the sequence (its backward a reduce-scatter) and its
exit ``reduce_scatter``.  A block computed whole on every rank enters by
``all_gather(..., sum_grad=False)`` and leaves by ``split``.  ``pmax`` is
a maximum for values no gradient flows through (the log-sum-exp's
shift).

**The training rule.**  A rank of a training step computes on its slice
of the batch: the batch is split over the plan's *batch* axes and
replicated over the others (``model``, and the *worker* axes, whose ranks
train other clients).  So a gathered leaf's gradient is summed over each
batch axis, and over no other axis:
:func:`repro_torch.distributed.sharding.gather_leaf` with ``batch_axes=``
gathers over a batch axis with the summing ``all_gather``, over any other
axis with ``sum_grad=False``, and passes a leaf replicated over a batch
axis through ``sum_grad``.  Where a layer is split over ``model``, a leaf
used on a rank's part of it counts ``model`` among its batch axes
(:mod:`repro_torch.models.lm`).  The serve path and the expert-parallel
dispatch keep the summing convention above.

On a gloo mesh a CUDA tensor crosses through the host, and bf16 and f16
are summed in f32 and rounded once, as one sum of them on the card would
be.  On a meta mesh nothing is sent: each collective returns a meta tensor
of its result's shape and reports its wire bytes per rank to the counter
that :func:`counting` made active, by the ring formulas of the reference's
``roofline.py`` (an all-gather ``(g-1)/g`` of its result's bytes, a
reduce-scatter ``(g-1)/g`` of its operand's, an all-reduce ``2 (g-1)/g``
of its operand's).  A gloo or NCCL mesh reports each collective to that
counter too, by the same formulas (a rank's bytes sent, which a ring
receives as well).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

__all__ = ["psum", "pmean", "pmax", "all_gather", "reduce_scatter", "split",
           "sum_grad", "axis_index", "Collective", "counting", "wire_bytes"]


@dataclass(frozen=True)
class Collective:
    """One collective a meta mesh recorded: its kind, the axis, the group
    size, the payload bytes, the wire bytes each rank sends and the
    payload's shape (an all-gather's result, a reduction's operand)."""

    kind: str
    axis: str
    group_size: int
    bytes: int
    wire_bytes: float
    shape: tuple = ()


# The receivers :func:`counting` made active, innermost last.  A process
# global, not a context variable: autograd runs a CUDA backward on a thread
# of its own, and its collectives count too.
_SINKS: list = []


@contextlib.contextmanager
def counting(sink):
    """Make ``sink(collective)`` the receiver of every collective this
    process runs inside the block (a backward's too)."""
    _SINKS.append(sink)
    try:
        yield
    finally:
        _SINKS.pop()


def wire_bytes(kind: str, nbytes: int, g: int) -> float:
    """Ring-algorithm bytes each rank sends: all-gather ``nbytes`` (its
    result) and reduce-scatter ``nbytes`` (its operand) × (g-1)/g,
    all-reduce 2 × ``nbytes`` × (g-1)/g."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    return nbytes * (g - 1) / g


def _record(kind: str, axis: str, g: int, nbytes: int, shape=()) -> None:
    if _SINKS:
        _SINKS[-1](Collective(kind, axis, g, nbytes,
                              wire_bytes(kind, nbytes, g), tuple(shape)))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _wire_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float32 if t.dtype in (torch.bfloat16, torch.float16) \
        else t.dtype


def _host(shape, dtype, device) -> torch.Tensor:
    """An empty host buffer: pinned when the data comes from or goes to a
    card (PyTorch's caching host allocator reuses it)."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def _all_reduce(x: torch.Tensor, mesh, axis: str, op: str = "sum"
                ) -> torch.Tensor:
    """The sum (or ``op="max"``) of ``x`` over ``axis`` (a new tensor)."""
    _record("all-reduce", axis, mesh.axis_size(axis), _nbytes(x), x.shape)
    if mesh.meta:
        return torch.empty_like(x)
    return _reduce(x, mesh, axis, op)


def _reduce(x: torch.Tensor, mesh, axis: str, op: str = "sum"
            ) -> torch.Tensor:
    """:func:`_all_reduce`'s transfer, unrecorded."""
    import torch.distributed as dist
    group = mesh.groups[axis]
    rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    if mesh.backend == "gloo" and (x.device.type != "cpu"
                                   or x.dtype != _wire_dtype(x)):
        buf = _host(x.shape, _wire_dtype(x), x.device)
        buf.copy_(x)
        dist.all_reduce(buf, op=rop, group=group)
        return buf.to(x.device, non_blocking=True).to(x.dtype)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=rop, group=group)
    return out


def _reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int
                    ) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, this rank's block of ``dim`` (a
    tensor of its own).  gloo has no reduce-scatter: there it is an
    all-reduce and a slice."""
    g = mesh.axis_size(axis)
    _record("reduce-scatter", axis, g, _nbytes(x), x.shape)
    n = x.shape[dim] // g
    if mesh.meta:
        shape = list(x.shape)
        shape[dim] = n
        return x.new_empty(shape)
    if mesh.backend == "nccl":
        import torch.distributed as dist
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=mesh.groups[axis])
        return out.movedim(0, dim).contiguous()
    i = mesh.axis_index(axis)
    return _reduce(x, mesh, axis).narrow(dim, i * n, n).clone(
        memory_format=torch.contiguous_format)


def _gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated on ``dim``."""
    g = mesh.axis_size(axis)
    shape = list(x.shape)
    shape[dim] *= g
    _record("all-gather", axis, g, _nbytes(x) * g, shape)
    if mesh.meta:
        return x.new_empty(shape)
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
            return (_reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None,
                    None, None, None)
        # A slice of its own storage: the whole cotangent can be freed.
        return (_block(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None,
                None)


def _block(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` along ``axis``, a tensor of its own."""
    n = x.shape[dim] // mesh.axis_size(axis)
    return x.narrow(dim, mesh.axis_index(axis) * n, n).clone(
        memory_format=torch.contiguous_format)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _block(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


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


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The maximum over the ranks along ``axis``; replicated, and no
    gradient flows through it."""
    return _all_reduce(x.detach(), mesh, axis, op="max")


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """Sum over the ranks along ``axis``, this rank's block of ``dim``
    kept; the backward all-gathers the blocks' cotangents."""
    return _ReduceScatter.apply(x, mesh, axis, dim)


def split(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` along ``axis`` (no traffic); the
    backward all-gathers the blocks' cotangents: ``x`` was computed whole
    on every rank, and each rank's block is its own part of the loss."""
    return _Split.apply(x, mesh, axis, dim)


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Mean over the ranks along ``axis``; replicated result."""
    return psum(x, mesh, axis) / mesh.axis_size(axis)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0, *,
               tiled: bool = True, sum_grad: bool = True) -> torch.Tensor:
    """The ranks' ``x`` along ``axis``, in rank order: concatenated on
    ``dim`` (``tiled``) or stacked on a new ``dim``.  The backward sums
    the ranks' cotangents and keeps this rank's slice (a reduce-scatter),
    or with ``sum_grad=False`` keeps this rank's slice of its own (see the
    module's docstring)."""
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
