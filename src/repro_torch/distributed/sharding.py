"""Sharding rules and the worker/host shard maps — port of
``repro/distributed/sharding.py``.

**Rules.**  Model parameters are nested dicts whose leaf *paths* (keys
joined with ``/``) follow :mod:`repro_torch.models.lm`'s naming (e.g.
``stack/p0/wq``, ``embed``, ``stack/p1/moe_up``).  A :class:`ShardingRules`
is an ordered list of (path regex, spec template); the first match wins.
A template names *logical* axes, resolved to mesh axes through the
policy's axis map:

    logical axes:  "tp"   — tensor-parallel (heads / ffn / vocab dims)
                   "fsdp" — fully-sharded param dim (usually d_model)
                   "ep"   — expert-parallel (MoE expert dim)
                   "fl"   — the FL-worker dim of round arrays
                   None   — replicated

Policies: ``tp`` (params replicated over data/pod), ``fsdp_tp`` and
``fsdp_tp_ep`` (FSDP over data/pod, experts over the model axis),
``fsdp_tp_noep`` (experts split like dense layers).  A *spec* is a tuple
with one entry per dim — a mesh axis name, a tuple of names, or ``None`` —
exactly a ``PartitionSpec``'s entries.  :func:`filter_spec` drops an axis
from a dim it does not divide; :func:`shard_tree` gives a rank its slice
of every leaf (the reference's ``named_shardings`` + ``device_put``) and
:func:`gather_leaf` puts a leaf back together.  :class:`ExpertSplit` is
the reference's ``act_shard_moe`` layout of a MoE layer's ``[E, C, ...]``
expert buffers, as a rank computes its block of them.

**Shard maps.**  A *shard* is the FL mesh path's unit of program dispatch
and device placement: workers map to shards by ``wid % n_shards``, so a
worker keeps its shard across elastic churn of other workers.  Devices
here are ``torch.device``s (:func:`repro_torch.launch.mesh
.fl_shard_devices`).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import torch

from repro_torch.distributed import collectives

__all__ = ["ShardingRules", "make_sharding_rules", "spec_for_tree",
           "filter_spec", "filtered_specs", "local_shape", "global_shape",
           "shard_leaf", "shard_tree", "gather_leaf", "split_axes",
           "write_local", "tree_paths", "ExpertSplit", "WorkerShardMap",
           "HostShardMap"]


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


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------
def _axis_names(mesh) -> tuple:
    """The axis names of a Mesh, of an ``{axis: size}`` dict, or of a tuple
    of names."""
    names = getattr(mesh, "axis_names", mesh)
    return tuple(names)


def _leaf_ndim(leaf) -> int:
    return leaf.ndim if isinstance(leaf, torch.Tensor) else len(leaf)


def tree_paths(tree, prefix: str = ""):
    """``(path, leaf)`` of every leaf of a nested dict, keys joined with
    ``/`` — the reference's leaf-path convention."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _map_paths(fn, tree, prefix: str = ""):
    return {k: _map_paths(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
            else fn(f"{prefix}{k}", v) for k, v in tree.items()}


@dataclass
class ShardingRules:
    """Ordered (regex, template) rules + logical→mesh axis resolution."""

    rules: list  # [(compiled_regex, tuple_of_logical_axes_or_None)]
    axis_map: dict  # logical -> mesh axis name (str) | tuple | None
    default: tuple = ()

    def resolve(self, template) -> tuple:
        out = []
        for ax in template:
            m = self.axis_map.get(ax, None) if ax is not None else None
            if isinstance(m, tuple) and len(m) == 1:
                m = m[0]
            out.append(m)
        return tuple(out)

    def spec_for_path(self, path: str) -> tuple:
        for rx, template in self.rules:
            if rx.search(path):
                return self.resolve(template)
        return ()

    def tree_specs(self, tree) -> dict:
        """The spec of every leaf of ``tree`` (a nested dict of tensors or
        shape tuples) by its path, cut to the leaf's rank."""
        return _map_paths(lambda path, leaf: self.spec_for_path(path)[
            :_leaf_ndim(leaf)], tree)


def _compile(rules):
    return [(re.compile(rx), tpl) for rx, tpl in rules]


# Leaf names (see repro_torch/models/lm.py): layer-stacked leaves live under
# "stack/p<i>/" with a leading n_periods dim; embeddings and final norms are
# unstacked.  embed [V,D] · lm_head [D,V] · wq|wk|wv [L,D,H*hd] · wo
# [L,H*hd,D] · w_gate|w_up [L,D,F] · w_down [L,F,D] · moe_{gate,up,down}
# [L,E,...] · router [L,D,E] · mamba_* · norms/biases replicated.
def make_sharding_rules(policy: str, mesh, *, fl_axes=("data",),
                        extra_rules=None) -> dict:
    """Rules for params, round arrays and serve-time caches, the
    reference's: ``{"params", "arrays", "kv": ShardingRules, "policy"}``.
    ``mesh``: a Mesh, an ``{axis: size}`` dict or the axis names."""
    axes = set(_axis_names(mesh))
    fl_axes = tuple(a for a in fl_axes if a in axes)
    # FSDP must not reuse an FL-worker axis (the worker dim owns it).
    fsdp_axes = tuple(a for a in ("pod", "data")
                      if a in axes and a not in fl_axes)
    fl = fl_axes if fl_axes else None
    if policy == "tp":
        # Experts are not expert-parallel; the per-expert hidden dim F
        # carries the TP shard (valid for any expert count).
        axis_map = {"tp": "model", "fsdp": None, "ep": None,
                    "moe_f": "model", "fl": fl}
    elif policy in ("fsdp_tp", "fsdp_tp_ep"):
        axis_map = {"tp": "model", "fsdp": fsdp_axes or None, "ep": "model",
                    "moe_f": None, "fl": fl}
    elif policy == "fsdp_tp_noep":
        axis_map = {"tp": "model", "fsdp": fsdp_axes or None, "ep": None,
                    "moe_f": "model", "fl": fl}
    else:
        raise ValueError(f"unknown sharding policy {policy!r}")

    param_rules = _compile((extra_rules or []) + [
        (r"(^|/)embed$",        ("tp", "fsdp")),         # [V, D]
        (r"(^|/)lm_head$",      ("fsdp", "tp")),         # [D, V]
        (r"(^|/)pos_embed$",    (None, None)),
        (r"(^|/)patch_proj$",   ("fsdp", "tp")),         # [d_vit, D]
        (r"/x?b[qkv]$",         (None, "tp")),
        (r"/x?bo$|/b_down$",    (None,)),
        (r"/b_up$",             (None, "tp")),
        (r"/wq$|/wk$|/wv$",     (None, "fsdp", "tp")),   # [L, D, H*hd]
        (r"/wo$",               (None, "tp", "fsdp")),   # [L, H*hd, D]
        (r"/w_gate$|/w_up$",    (None, "fsdp", "tp")),   # [L, D, F]
        (r"/w_down$",           (None, "tp", "fsdp")),   # [L, F, D]
        (r"/moe_gate$|/moe_up$", (None, "ep", "fsdp", "moe_f")),
        (r"/moe_down$",          (None, "ep", "moe_f", "fsdp")),
        (r"/router$",            (None, "fsdp", None)),  # [L, D, E]
        (r"/mamba_in$",         (None, "fsdp", "tp")),
        (r"/mamba_out$",        (None, "tp", "fsdp")),
        (r"/mamba_conv$",       (None, None, "tp")),
        (r"/mamba_(A|dt_bias|D)$", (None, "tp")),
        (r"norm|bias|scale|ln_",  ()),
    ])
    array_rules = _compile([(r".*", ("fl",))])
    # Cache [p{i}][leaf], leading n_periods dim: k/v/xk/xv [np, B, T, Hkv,
    # hd] batch over data(+pod), length over model; conv [np, B, k-1, C]
    # channels over model; ssm [np, B, H, p, n] heads over model.
    kv_rules = _compile([
        (r"/(k|v|xk|xv)$", (None, "kvbatch", "kvseq", None, None)),
        (r"/conv$",        (None, "kvbatch", None, "tp")),
        (r"/ssm$",         (None, "kvbatch", "tp", None, None)),
        (r".*", ("kvbatch",)),
    ])
    kv_axis_map = dict(axis_map)
    kv_axis_map.update({
        "kvbatch": tuple(a for a in ("pod", "data") if a in axes) or None,
        "kvseq": "model",
    })
    return {
        "params": ShardingRules(rules=param_rules, axis_map=axis_map),
        "arrays": ShardingRules(rules=array_rules, axis_map=axis_map),
        "kv": ShardingRules(rules=kv_rules, axis_map=kv_axis_map),
        "policy": policy,
    }


def spec_for_tree(rules: ShardingRules, tree) -> dict:
    return rules.tree_specs(tree)


# ---------------------------------------------------------------------------
# specs on shapes: filter, local shapes, slices, gathers
# ---------------------------------------------------------------------------
def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def filter_spec(spec, shape, ax: dict) -> tuple:
    """Drop mesh axes from dims they do not evenly divide (batch-1 cells,
    whisper's 1,500 frames, ...) and axes of size 1 — the reference's
    ``_filter_spec``: sharding must follow shape."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        keep, size = [], shape[i]
        for a in _entry_axes(entry):
            n = ax.get(a, 1)
            if size % n == 0 and n > 1:
                keep.append(a)
                size //= n
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep
                                                      else None))
    return tuple(out)


@dataclass(frozen=True, eq=False)
class ExpertSplit:
    """The ``act_shard_moe`` hook (the reference's ``_mk_moe_shard``): a MoE
    layer's ``[E, C, ...]`` expert buffers split over ``axis`` of ``mesh``
    — by experts where ``E`` divides the axis, else by capacity where
    ``C`` does, else not at all.  A rank computes its block of the buffers
    (:func:`~repro_torch.models.layers._moe_dispatch`) where the reference
    constrains XLA's layout of them."""

    mesh: object
    axis: str = "model"

    @property
    def m(self) -> int:
        return self.mesh.axis_size(self.axis)

    @property
    def r(self) -> int:
        return self.mesh.axis_index(self.axis)

    def dim(self, E: int, C: int) -> int | None:
        """The buffers' dim split over the axis: 0 (experts), 1 (capacity)
        or None."""
        if E % self.m == 0:
            return 0
        if C % self.m == 0:
            return 1
        return None


def filtered_specs(spec_tree, shape_tree, mesh) -> dict:
    """:func:`filter_spec` of every leaf (the reference's
    ``_filtered_ns``); ``shape_tree`` holds tensors or shape tuples."""
    from repro_torch.launch.mesh import axis_sizes
    ax = axis_sizes(mesh)

    def walk(specs, shapes):
        return {k: walk(specs[k], v) if isinstance(v, dict) else
                filter_spec(specs[k], tuple(getattr(v, "shape", v)), ax)
                for k, v in shapes.items()}

    return walk(spec_tree, shape_tree)


def local_shape(shape, spec, mesh) -> tuple:
    """A rank's shard shape of a leaf of ``shape`` under ``spec`` (the
    reference's ``NamedSharding.shard_shape``)."""
    from repro_torch.launch.mesh import axis_sizes
    ax = axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        n = math.prod(ax[a] for a in _entry_axes(entry))
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {entry} ({n})")
        out[i] //= n
    return tuple(out)


def _block(entry, mesh) -> tuple:
    """(this rank's block index, the block count) along a dim split over
    ``entry``'s axes, the first axis outermost."""
    idx, n = 0, 1
    for a in _entry_axes(entry):
        idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
        n *= mesh.axis_size(a)
    return idx, n


def global_shape(shape, spec, mesh) -> tuple:
    """The whole leaf's shape from a rank's shard ``shape``."""
    return tuple(d * _block(spec[i], mesh)[1] if i < len(spec) else d
                 for i, d in enumerate(shape))


def shard_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's slice of ``x`` under ``spec``, as a tensor of its own
    (the full ``x`` can be freed)."""
    for i, entry in enumerate(spec):
        idx, n = _block(entry, mesh)
        if n == 1:
            continue
        if x.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(x.shape)} does not divide "
                             f"over {entry} ({n})")
        block = x.shape[i] // n
        x = x.narrow(i, idx * block, block)
    return x.clone(memory_format=torch.contiguous_format)


def shard_tree(tree, specs, mesh) -> dict:
    """This rank's slice of every leaf of ``tree`` under ``specs``."""
    return {k: shard_tree(v, specs[k], mesh) if isinstance(v, dict)
            else shard_leaf(v, specs[k], mesh) for k, v in tree.items()}


def gather_leaf(x: torch.Tensor, spec, mesh, *,
                batch_axes=None) -> torch.Tensor:
    """The whole leaf from this rank's slice ``x``: all-gathered over the
    axes of each dim, the last axis of a tuple first (its blocks are the
    innermost); an axis of one rank gathers nothing.

    The backward sums the ranks' cotangents over every axis it gathered
    (the serve convention of :mod:`~repro_torch.distributed.collectives`).
    A training step passes its ``batch_axes`` (the axes its batch is split
    over) for the training rule instead: the leaf's gradient is summed over
    each batch axis, whether the leaf is split over it (a reduce-scatter)
    or replicated (an all-reduce), and over no other axis, since there
    each rank's cotangent already is the whole gradient."""
    if batch_axes is not None:
        held = {a for entry in spec for a in _entry_axes(entry)}
        x = collectives.sum_grad(x, mesh, tuple(a for a in batch_axes
                                                if a not in held))
    for i, entry in enumerate(spec):
        for a in reversed(_entry_axes(entry)):
            if mesh.axis_size(a) > 1:
                x = collectives.all_gather(
                    x, mesh, a, dim=i,
                    sum_grad=batch_axes is None or a in batch_axes)
    return x


def split_axes(spec, axes) -> tuple:
    """``(kept, dropped)``: ``spec`` without the mesh ``axes``, and ``spec``
    with only them.  A training rank's lane holds its leaves under
    ``kept`` (replicated over the worker axes, whose ranks train other
    clients), so gathering ``x`` over ``dropped`` turns a shard under
    ``spec`` into one under ``kept``.  A dropped axis must be the last of
    its dim's axes: its blocks are then the innermost."""
    kept, dropped = [], []
    for entry in spec:
        ax = _entry_axes(entry)
        k = tuple(a for a in ax if a not in axes)
        d = tuple(a for a in ax if a in axes)
        if d and ax[len(k):] != d:
            raise ValueError(f"spec {spec}: axes {d} are not the innermost "
                             f"of {entry}")
        kept.append(k if len(k) > 1 else (k[0] if k else None))
        dropped.append(d if len(d) > 1 else (d[0] if d else None))
    return tuple(kept), tuple(dropped)


def write_local(local: torch.Tensor, val: torch.Tensor, spec, mesh,
                start: int = 0, dim: int = 1) -> None:
    """Copy into this rank's slice ``local`` (under ``spec``) the part of
    ``val`` it holds: ``val`` spans the whole leaf along every dim but
    ``dim``, where it covers ``[start, start + val.shape[dim])``."""
    dst, src = local, val
    for i in range(local.ndim):
        idx, _ = _block(spec[i] if i < len(spec) else None, mesh)
        lo, blk = idx * local.shape[i], local.shape[i]
        off = start if i == dim else 0
        a, b = max(lo, off), min(lo + blk, off + val.shape[i])
        if b <= a:
            return
        dst = dst.narrow(i, a - lo, b - a)
        src = src.narrow(i, a - off, b - a)
    dst.copy_(src)
