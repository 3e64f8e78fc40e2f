"""Operation-level cost of one step, counted as it runs — the port's
counterpart of ``repro/launch/hlo_cost.py``.

The reference walks a compiled XLA program's HLO text, propagating loop
trip counts through the call graph because ``cost_analysis()`` counts a
``while`` body once.  The port runs eagerly, so it counts what runs:
:func:`analyze_step` executes the step under a ``TorchDispatchMode`` and
sees every aten operation, every loop trip included — on meta tensors
(shapes only: nothing is allocated or computed, so a 235 B-parameter round
counts on a laptop) or on real ones.  Its rules are ``hlo_cost.py``'s:

* ``flops`` — 2·M·N·K a matrix product (``torch.utils.flop_counter``'s
  formulas for ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and convolutions),
  1 an output element for a pointwise op, the input elements for a
  reduction; split by dtype (a product's by its operands', the rest by
  their result's; a boolean result by its operands');
* ``bytes`` — one read of each tensor operand (the elements it spans: an
  expanded dim counts once) and one write of each output, the eager
  counterpart of "one HBM pass per fusion"; a view and an empty
  allocation move none;
* each hand-written kernel's call (a meta tensor takes the kernel route's
  meta branch) adds its work from :mod:`repro_torch.kernels.work`;
* each collective a meta mesh runs (:mod:`repro_torch.distributed
  .collectives`) adds its count, payload and ring wire bytes per rank
  (``collectives`` by kind, ``collectives_by_axis`` by ``kind/axis`` with
  its largest payload; ``wire_bytes_ici`` inside a pod, ``wire_bytes_dcn``
  over the ``pod`` axis), and the buffer it returns counts as live;
* ``peak_live_bytes`` — the step's arguments plus the most bytes of
  storages it allocated that were alive at once, tracked at allocation and
  at free (a storage's finalizer), plus, during an op, the workspace it
  allocates and frees inside itself where PyTorch's CUDA implementation
  is known to (:func:`_workspace`).

An operation whose result depends on data on meta tensors (a value read
back to the host, an output whose shape depends on values) cannot be
counted: it raises :class:`DataDependentOp` naming it.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import collectives as coll
from repro_torch.kernels import work

__all__ = ["OpCost", "DataDependentOp", "analyze_step", "MATMUL_OPS"]

aten = torch.ops.aten
MATMUL_OPS = ("mm", "addmm", "bmm", "baddbmm")
_FLOP_OPS = {p: flop_registry[p] for p in (
    aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
    aten._convolution, aten.convolution_backward)}
# Reductions by name where the op carries no reduction tag.
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp",
           "_softmax", "_log_softmax", "cumsum", "prod", "norm",
           "linalg_vector_norm", "var", "std", "var_mean", "argmax",
           "argmin", "any", "all", "softmax", "log_softmax"}
_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided"}
# Copies and fills: pointwise by tag, but no arithmetic (hlo_cost counts
# neither a copy nor a broadcast constant).
_NO_FLOPS = {"clone", "copy", "copy_", "_to_copy", "lift_fresh_copy",
             "fill", "fill_", "zero_", "zeros", "zeros_like", "ones",
             "ones_like", "full", "full_like", "new_zeros", "new_ones",
             "new_full"}
_TAG_DATA = (torch.Tag.data_dependent_output, torch.Tag.dynamic_output_shape)
_SOFTMAX = {"_softmax", "_log_softmax", "_softmax_backward_data",
            "_log_softmax_backward_data"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _workspace(name: str, ins: list, outs: list) -> int:
    """Bytes an op holds inside itself beyond its inputs and outputs, on
    the card, where PyTorch's CUDA implementation is known to: the softmax
    kernels copy each non-contiguous operand to a contiguous one
    (``host_softmax``, ``host_softmax_backward``), the softmax backward
    first forms ``grad * output`` at the output's size, and ``logsumexp``
    holds ``exp(x - max)`` at its input's size.  A count of the storages
    alive between ops cannot see them; the softmax backward of dense
    attention scores is the largest buffer of a train step."""
    if name in _SOFTMAX:
        extra = sum(_nbytes(t) for t in ins if not t.is_contiguous())
        if name == "_softmax_backward_data":
            extra += _nbytes(outs[0])
        return extra
    if name == "logsumexp" and ins:
        return _nbytes(ins[0])
    return 0


class DataDependentOp(RuntimeError):
    """An operation that needs values a meta tensor does not hold."""

    def __init__(self, op: str):
        super().__init__(f"{op} depends on tensor values: the step reads a "
                         f"value back to the host or makes a shape from "
                         f"data, which a meta run cannot count")
        self.op = op


@dataclass
class OpCost:
    flops: dict = field(default_factory=dict)    # dtype name -> FLOPs
    bytes: float = 0.0
    matmul_flops: float = 0.0                    # aten products alone
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_live_bytes: int = 0
    ops: int = 0
    by_op: dict = field(default_factory=dict)    # op -> count/flops/bytes
    kernels: dict = field(default_factory=dict)  # kernel -> calls/flops/bytes
    collectives: dict = field(default_factory=dict)  # kind -> count/bytes/wire
    collectives_by_axis: dict = field(default_factory=dict)  # + max_bytes
    wire_bytes_ici: float = 0.0                  # per rank, inside a pod
    wire_bytes_dcn: float = 0.0                  # per rank, over "pod"

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _touched(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` spans: its numel with stride-0 (expanded)
    dims counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(tree, out=None) -> list:
    """The tensors of an op's arguments or results (tuples, lists and dict
    values, nested)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


class _Counter(TorchDispatchMode):
    def __init__(self, cost: OpCost, known: set):
        super().__init__()
        self.cost = cost
        self.known = known            # storages of the step's arguments
        self.live = 0
        self.owned: set = set()

    def _free(self, key, nbytes):
        self.owned.discard(key)
        self.live -= nbytes

    def _add(self, name: str, flops: float, nbytes: float, dtype: str):
        c = self.cost
        if flops:
            c.flops[dtype] = c.flops.get(dtype, 0.0) + flops
        c.bytes += nbytes
        row = c.by_op.setdefault(name, {"count": 0, "flops": 0.0,
                                        "bytes": 0.0})
        row["count"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes

    def kernel(self, kernel: str, w: work.Work):
        row = self.cost.kernels.setdefault(kernel, {
            "calls": 0, "flops": 0, "bytes": 0, "dtype": _name(w.dtype)})
        row["calls"] += 1
        row["flops"] += w.flops
        row["bytes"] += w.bytes
        self._add(f"kernel:{kernel}", w.flops, w.bytes, _name(w.dtype))

    def collective(self, c: coll.Collective):
        row = self.cost.collectives.setdefault(c.kind, {
            "count": 0, "bytes": 0, "wire_bytes": 0.0})
        row["count"] += 1
        row["bytes"] += c.bytes
        row["wire_bytes"] += c.wire_bytes
        row = self.cost.collectives_by_axis.setdefault(
            f"{c.kind}/{c.axis}", {"count": 0, "bytes": 0, "wire_bytes": 0.0,
                                   "max_bytes": 0})
        row["count"] += 1
        row["bytes"] += c.bytes
        row["wire_bytes"] += c.wire_bytes
        row["max_bytes"] = max(row["max_bytes"], c.bytes)
        if c.axis == "pod":
            self.cost.wire_bytes_dcn += c.wire_bytes
        else:
            self.cost.wire_bytes_ici += c.wire_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        name = func.overloadpacket.__name__
        try:
            out = func(*args, **kwargs)
        except (RuntimeError, NotImplementedError) as e:
            # A meta tensor holds no values: an op that needs them fails.
            if func is aten._local_scalar_dense.default or any(
                    t in func.tags for t in _TAG_DATA):
                raise DataDependentOp(f"aten.{name}") from e
            raise
        outs = _tensors(out)
        self.cost.ops += 1
        in_keys = {_storage_key(t) for t in ins}
        # Allocation: an output storage no argument or earlier op made.
        for t in outs:
            key = _storage_key(t)
            if key in in_keys or key in self.known or key in self.owned:
                continue
            st = t.untyped_storage()
            nbytes = st.nbytes()
            self.owned.add(key)
            self.live += nbytes
            self.cost.peak_live_bytes = max(self.cost.peak_live_bytes,
                                            self.live)
            weakref.finalize(st, self._free, key, nbytes)
        extra = _workspace(name, ins, outs)
        if extra:
            self.cost.peak_live_bytes = max(self.cost.peak_live_bytes,
                                            self.live + extra)
        mutates = func._schema.is_mutable
        if not mutates and outs and all(_storage_key(t) in in_keys
                                         for t in outs):
            return out                                      # a view
        flops, dtype = 0.0, _name(outs[0].dtype) if outs else "float32"
        if func.overloadpacket in _FLOP_OPS:
            flops = float(_FLOP_OPS[func.overloadpacket](
                *args, out_val=out, **kwargs))
            dtype = _name(ins[0].dtype)
            if name in MATMUL_OPS:
                self.cost.matmul_flops += flops
        elif outs and (torch.Tag.reduction in func.tags
                       or name in _REDUCE):
            flops = float(ins[0].numel()) if ins else 0.0
            dtype = _name(ins[0].dtype) if ins else dtype
        elif outs and torch.Tag.pointwise in func.tags \
                and name not in _NO_FLOPS:
            flops = float(sum(t.numel() for t in outs))
            if outs[0].dtype == torch.bool and ins:
                dtype = _name(ins[0].dtype)
        nbytes = 0
        if name not in _NO_WRITE:
            seen = set()
            for t in ins:
                key = (_storage_key(t), t.storage_offset(), tuple(t.shape),
                       tuple(t.stride()))
                if key not in seen:
                    seen.add(key)
                    nbytes += _touched(t)
            nbytes += sum(_touched(t) for t in outs)
        self._add(f"aten.{name}", flops, nbytes, dtype)
        return out


def analyze_step(fn, *args, **kwargs) -> OpCost:
    """Run ``fn(*args, **kwargs)`` once under the counter and return its
    :class:`OpCost`; the step's arguments count as live throughout, its
    outputs' bytes are ``output_bytes``."""
    cost = OpCost()
    arg_storages = {}
    for t in _tensors((args, kwargs)):
        arg_storages.setdefault(_storage_key(t), t.untyped_storage().nbytes())
    cost.argument_bytes = sum(arg_storages.values())
    counter = _Counter(cost, set(arg_storages))
    # Under a dispatch mode a checkpointed region's recomputation stops
    # early (at its last saved tensor); the step run plainly recomputes
    # each region whole (its profile's matrix products say so), so the
    # count does too.
    with work.counting(counter.kernel), coll.counting(counter.collective), \
            set_checkpoint_early_stop(False), counter:
        out = fn(*args, **kwargs)
    cost.peak_live_bytes += cost.argument_bytes
    outs = {}
    for t in _tensors(out):
        outs.setdefault(_storage_key(t), t.untyped_storage().nbytes())
    cost.output_bytes = sum(outs.values())
    cost.bytes = float(cost.bytes)
    del out
    return cost
