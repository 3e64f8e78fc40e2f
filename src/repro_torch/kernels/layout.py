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
    """``{name: view}`` over one flat ``lead + [N]`` buffer (``.flat``),
    laid out by ``.layout``; read-only (:class:`ReadOnlyTree`)."""

    __slots__ = ("flat", "layout")


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
    """Leaf names, shapes and offsets of a param dict laid out flat."""

    def __init__(self, params: dict, *, lead: int = 0):
        """``params``: ``{name: tensor}``; the first ``lead`` dims of every
        leaf are batch dims, not part of the layout."""
        self.names = sorted(params)
        self.shapes = [tuple(params[k].shape[lead:]) for k in self.names]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.offsets = [0]
        for size in self.sizes:
            self.offsets.append(self.offsets[-1] + size)
        self.n = self.offsets[-1]
        dtypes = {params[k].dtype for k in self.names}
        if len(dtypes) != 1:
            raise TypeError(f"a flat layout needs one dtype, got "
                            f"{sorted(map(str, dtypes))}")
        self._offsets_on: dict = {}
        self._leaf_index_on: dict = {}
        self._scalars: FlatLayout | None = None

    def __eq__(self, other) -> bool:
        return (isinstance(other, FlatLayout) and self.names == other.names
                and self.shapes == other.shapes)

    def __hash__(self) -> int:
        return hash((tuple(self.names), tuple(self.shapes)))

    @classmethod
    def of(cls, tree: dict, *, lead: int = 0) -> "FlatLayout":
        """The layout of ``tree``: its own for a :class:`FlatTree`."""
        if isinstance(tree, FlatTree):
            return tree.layout
        return cls(tree, lead=lead)

    def flatten(self, tree: dict, lead: tuple = ()) -> torch.Tensor:
        """Leaves shaped ``lead + shape`` -> one ``lead + [N]`` tensor (the
        tree's own buffer, without a copy, for a :class:`FlatTree`)."""
        lead = tuple(lead)
        if (isinstance(tree, FlatTree)
                and tuple(tree.flat.shape) == lead + (self.n,)):
            return tree.flat
        return torch.cat([tree[k].reshape(lead + (-1,)) for k in self.names],
                         dim=-1)

    def views(self, flat: torch.Tensor) -> FlatTree:
        """``[..., N]`` -> ``{name: [..., *shape]}`` views (no copies)."""
        lead = tuple(flat.shape[:-1])
        out = FlatTree(
            (k, flat[..., off:off + size].view(lead + shape))
            for k, shape, off, size in zip(self.names, self.shapes,
                                           self.offsets, self.sizes))
        out.flat = flat
        out.layout = self
        return out

    def scalars(self) -> "FlatLayout":
        """The layout of one scalar per leaf (the int8 payload's scales)."""
        if self._scalars is None:
            self._scalars = FlatLayout({k: torch.empty(())
                                        for k in self.names})
        return self._scalars

    def offsets_on(self, device) -> torch.Tensor:
        """The leaf offsets ``[n_leaves + 1]`` as int64 on ``device``
        (K2's leaf table), made once per device."""
        device = torch.device(device)
        t = self._offsets_on.get(device)
        if t is None:
            t = torch.tensor(self.offsets, dtype=torch.int64).to(device)
            self._offsets_on[device] = t
        return t

    def per_element(self, values: torch.Tensor) -> torch.Tensor:
        """One value per leaf ``[..., n_leaves]`` -> ``[..., N]``, each
        repeated over its leaf: one gather through a cached leaf index
        (``repeat_interleave`` recomputes its index every call)."""
        device = values.device
        index = self._leaf_index_on.get(device)
        if index is None:
            index = torch.repeat_interleave(
                torch.arange(len(self.names), dtype=torch.int32),
                torch.tensor(self.sizes)).to(device)
            self._leaf_index_on[device] = index
        return values.index_select(-1, index)


def tree_cat(trees: list, dim: int = 0) -> dict:
    """Concatenate trees leaf by leaf along a lead dim ``dim``; flat trees
    of one layout concatenate as one buffer."""
    first = trees[0]
    if all(isinstance(t, FlatTree) and t.layout == first.layout
           for t in trees):
        return first.layout.views(torch.cat([t.flat for t in trees], dim=dim))
    return {k: torch.cat([t[k] for t in trees], dim=dim) for k in first}


def tree_stack(trees: list) -> dict:
    """Stack trees leaf by leaf along a new lead dim."""
    first = trees[0]
    if all(isinstance(t, FlatTree) and t.layout == first.layout
           for t in trees):
        return first.layout.views(torch.stack([t.flat for t in trees]))
    return {k: torch.stack([t[k] for t in trees]) for k in first}
