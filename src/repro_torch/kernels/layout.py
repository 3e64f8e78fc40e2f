"""The flat layout the kernels fold over: a param dict as one flat vector.

Leaves sit in sorted-name order (JAX's dict flattening order, so per-leaf
sums keep the reference's association).  K1 folds ``[L, N]`` lane buffers
of this layout; K2 folds one ``[N]`` payload with a per-leaf scale table
and the layout's leaf offsets.

A :class:`FlatTree` is a param dict whose leaves are views of one flat
buffer, which it keeps as ``.flat``: :meth:`FlatLayout.flatten` hands that
buffer back without a copy, so trees can pass between the round's programs
as dicts (as the reference's pytrees do) while every program works on one
flat tensor.

A tree of several dtypes (a published LM config: bf16 matrices beside f32
norm scales and Mamba rows) is laid out per dtype group: each group is a
single-dtype layout of its own leaves, in the same sorted order, with its
own flat buffer.  :meth:`FlatLayout.flatten_groups` and :meth:`FlatLayout
.views` take ``{key: buffer}`` dicts, one entry per group (``"flat"`` for
a single-dtype tree, the dtype's name otherwise), and a mixed tree's
buffers are its ``.flats``: every round program works on these.

The compression family computes in f32 for every leaf, as the reference
does.  It works on a layout's f32 twin (:attr:`FlatLayout.twin`): the same
names and shapes in the same order as one single-dtype f32 layout.
:meth:`FlatLayout.to_twin` upcasts each leaf into it (exact from bf16), and
:meth:`FlatLayout.from_twin` casts a twin buffer back to the group
buffers, each leaf to its own dtype.  The one-buffer methods (``flatten``,
``.flat``, the leaf offsets and scale tables) need a single-dtype layout,
and raise on a mixed one.
"""

from __future__ import annotations

import math

import torch

__all__ = ["FlatLayout", "FlatTree", "ReadOnlyTree", "flatten_tree",
           "unflatten_tree", "tree_cat", "tree_stack"]

SEP = "/"


class ReadOnlyTree(dict):
    """A dict of views of a flat buffer that refuses to be changed: the
    buffer is what programs read, so a leaf set into the dict would be
    silently ignored.  Build a new tree with :meth:`FlatLayout.views`
    instead (or write into a leaf's view in place)."""

    __slots__ = ()

    def _read_only(self, *args, **kwargs):
        raise TypeError("a FlatTree's leaves are views of its .flat buffer "
                        "and cannot be replaced; build a new tree with "
                        "FlatLayout.views")

    __setitem__ = __delitem__ = __ior__ = _read_only
    update = pop = popitem = setdefault = clear = _read_only


class FlatTree(ReadOnlyTree):
    """``{name: view}`` over one flat ``lead + [n_g]`` buffer per dtype
    group (``.flats``; ``.flat`` for a single-dtype tree), laid out by
    ``.layout``; read-only (:class:`ReadOnlyTree`)."""

    __slots__ = ("flats", "layout")

    @property
    def flat(self) -> torch.Tensor:
        """The one flat buffer of a single-dtype tree."""
        self.layout.require_single("a FlatTree's .flat")
        return self.flats["flat"]

    @property
    def device(self) -> torch.device:
        return next(iter(self.flats.values())).device

    def map(self, fn) -> "FlatTree":
        """A tree of the same layout over ``fn(buffer)`` of each group's
        buffer (a lane picked out, a reshape, a move to another device)."""
        return self.layout.views({k: fn(f) for k, f in self.flats.items()})


def flatten_tree(tree: dict) -> dict:
    """A nested param dict as ``{path: leaf}``, each path its keys joined
    with ``/``; a dict without nested dicts comes back as it is."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            for sub, leaf in flatten_tree(v).items():
                out[f"{k}{SEP}{sub}"] = leaf
        else:
            out[k] = v
    return out


def unflatten_tree(flat: dict) -> ReadOnlyTree:
    """Inverse of :func:`flatten_tree` (the same leaf objects, no copies),
    every level a :class:`ReadOnlyTree`."""
    out: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split(SEP)
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = leaf
    return _frozen(out)


def _frozen(tree: dict) -> ReadOnlyTree:
    return ReadOnlyTree((k, _frozen(v) if isinstance(v, dict) else v)
                        for k, v in tree.items())


class FlatLayout:
    """Leaf names, shapes, dtypes and offsets of a param dict laid out
    flat: one buffer for a single-dtype dict, one per dtype group (each a
    single-dtype :class:`FlatLayout`, ``.groups``) for a mixed one."""

    def __init__(self, params: dict, *, lead: int = 0):
        """``params``: ``{name: tensor}``; the first ``lead`` dims of every
        leaf are batch dims, not part of the layout."""
        self.names = sorted(params)
        self.shapes = [tuple(params[k].shape[lead:]) for k in self.names]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.dtypes = [params[k].dtype for k in self.names]
        self.n = sum(self.sizes)
        kinds = list(dict.fromkeys(self.dtypes))
        self.mixed = len(kinds) > 1
        if self.mixed:
            # Groups in the order their dtype first appears in leaf order.
            self.groups = tuple(
                FlatLayout({k: params[k] for k, d in zip(self.names,
                                                         self.dtypes)
                            if d == kind}, lead=lead)
                for kind in kinds)
            self.keys = tuple(str(kind).removeprefix("torch.")
                              for kind in kinds)
            self.offsets = None
        else:
            self.groups = (self,)
            self.keys = ("flat",)
            self.offsets = [0]
            for size in self.sizes:
                self.offsets.append(self.offsets[-1] + size)
        self._offsets_on: dict = {}
        self._scalars: FlatLayout | None = None
        self._twin: FlatLayout | None = None

    def __eq__(self, other) -> bool:
        return (isinstance(other, FlatLayout) and self.names == other.names
                and self.shapes == other.shapes
                and self.dtypes == other.dtypes)

    def __hash__(self) -> int:
        return hash((tuple(self.names), tuple(self.shapes),
                     tuple(self.dtypes)))

    def require_single(self, what: str) -> None:
        """Raise unless the layout holds one dtype: ``what`` works on one
        flat buffer, which a mixed layout does not have."""
        if self.mixed:
            raise ValueError(
                f"{what} needs a single-dtype layout, got dtype groups "
                f"{list(self.keys)}: use the group buffers "
                f"(flatten_groups, views of a dict) or the f32 twin")

    @property
    def twin(self) -> "FlatLayout":
        """The f32 twin: this layout's names and shapes as one single-dtype
        f32 layout (the layout itself when it is one already)."""
        if self._twin is None:
            if not self.mixed and self.dtypes[0] == torch.float32:
                self._twin = self
            else:
                self._twin = FlatLayout(
                    {k: torch.empty(s, dtype=torch.float32, device="meta")
                     for k, s in zip(self.names, self.shapes)})
        return self._twin

    def to_twin(self, tree: dict, lead: tuple = ()) -> torch.Tensor:
        """Leaves shaped ``lead + shape`` -> one f32 ``lead + [N]`` buffer
        of the twin, each leaf upcast (the tree's own buffer, without a
        copy, for a single-dtype f32 tree)."""
        if not self.mixed:
            return self.flatten(tree, lead).float()
        lead = tuple(lead)
        return torch.cat([tree[k].reshape(lead + (-1,)).float()
                          for k in self.names], dim=-1)

    def from_twin(self, flat: torch.Tensor) -> dict:
        """A twin buffer ``[..., N]`` -> ``{key: [..., n_g]}``, one buffer
        per dtype group, each leaf cast to its own dtype."""
        if not self.mixed:
            return {"flat": flat.to(self.dtypes[0])}
        start = dict(zip(self.names, self.twin.offsets))
        return {key: torch.cat([flat[..., start[k]:start[k] + size]
                                for k, size in zip(g.names, g.sizes)],
                               dim=-1).to(g.dtypes[0])
                for key, g in zip(self.keys, self.groups)}

    @classmethod
    def of(cls, tree: dict, *, lead: int = 0) -> "FlatLayout":
        """The layout of ``tree``: its own for a :class:`FlatTree`."""
        if isinstance(tree, FlatTree):
            return tree.layout
        return cls(tree, lead=lead)

    def flatten(self, tree: dict, lead: tuple = ()) -> torch.Tensor:
        """Leaves shaped ``lead + shape`` -> one ``lead + [N]`` tensor (the
        tree's own buffer, without a copy, for a :class:`FlatTree`)."""
        self.require_single("FlatLayout.flatten")
        lead = tuple(lead)
        if (isinstance(tree, FlatTree)
                and tuple(tree.flats["flat"].shape) == lead + (self.n,)):
            return tree.flats["flat"]
        return torch.cat([tree[k].reshape(lead + (-1,)) for k in self.names],
                         dim=-1)

    def flatten_groups(self, tree: dict, lead: tuple = ()) -> dict:
        """Leaves shaped ``lead + shape`` -> ``{key: lead + [n_g]}``, one
        buffer per dtype group (a :class:`FlatTree`'s own, without a
        copy)."""
        if isinstance(tree, FlatTree) and tree.layout == self and all(
                tuple(f.shape[:-1]) == tuple(lead)
                for f in tree.flats.values()):
            return dict(tree.flats)
        return {key: g.flatten(tree, lead)
                for key, g in zip(self.keys, self.groups)}

    def views(self, flat) -> FlatTree:
        """``[..., N]`` (or ``{key: [..., n_g]}``, one buffer per dtype
        group) -> ``{name: [..., *shape]}`` views (no copies)."""
        if not isinstance(flat, dict):
            self.require_single("FlatLayout.views of one buffer")
        flats = flat if isinstance(flat, dict) else {"flat": flat}
        if self.mixed:
            out = FlatTree(sorted(
                ((k, v) for key, g in zip(self.keys, self.groups)
                 for k, v in g.views(flats[key]).items()),
                key=lambda kv: kv[0]))
        else:
            flat = flats["flat"]
            lead = tuple(flat.shape[:-1])
            out = FlatTree(
                (k, flat[..., off:off + size].view(lead + shape))
                for k, shape, off, size in zip(self.names, self.shapes,
                                               self.offsets, self.sizes))
        out.flats = flats
        out.layout = self
        return out

    def scalars(self) -> "FlatLayout":
        """The layout of one scalar per leaf (the int8 payload's scales)."""
        self.require_single("FlatLayout.scalars")
        if self._scalars is None:
            self._scalars = FlatLayout({k: torch.empty(())
                                        for k in self.names})
        return self._scalars

    def offsets_on(self, device) -> torch.Tensor:
        """The leaf offsets ``[n_leaves + 1]`` as int64 on ``device``
        (K2's leaf table), made once per device."""
        self.require_single("FlatLayout.offsets_on")
        device = torch.device(device)
        t = self._offsets_on.get(device)
        if t is None:
            t = torch.tensor(self.offsets, dtype=torch.int64).to(device)
            self._offsets_on[device] = t
        return t

    def per_element(self, values: torch.Tensor) -> torch.Tensor:
        """One value per leaf ``[..., n_leaves]`` -> ``[..., N]``, each
        repeated over its leaf: each value broadcast over its leaf and the
        leaves concatenated.  No per-element index is built or kept: a
        cached one would hold 4 bytes a parameter on the device between
        rounds."""
        self.require_single("FlatLayout.per_element")
        lead = tuple(values.shape[:-1])
        return torch.cat([values[..., i:i + 1].expand(lead + (n,))
                          for i, n in enumerate(self.sizes)], dim=-1)


def tree_cat(trees: list, dim: int = 0) -> dict:
    """Concatenate trees leaf by leaf along a lead dim ``dim``; flat trees
    of one layout concatenate buffer by buffer."""
    first = trees[0]
    if all(isinstance(t, FlatTree) and t.layout == first.layout
           for t in trees):
        return first.layout.views({
            key: torch.cat([t.flats[key] for t in trees], dim=dim)
            for key in first.flats})
    return {k: torch.cat([t[k] for t in trees], dim=dim) for k in first}


def tree_stack(trees: list) -> dict:
    """Stack trees leaf by leaf along a new lead dim."""
    first = trees[0]
    if all(isinstance(t, FlatTree) and t.layout == first.layout
           for t in trees):
        return first.layout.views({
            key: torch.stack([t.flats[key] for t in trees])
            for key in first.flats})
    return {k: torch.stack([t[k] for t in trees]) for k in first}
