"""Fault-tolerant checkpointing: atomic npz snapshots + JSON manifest —
port of ``repro/checkpoint/store.py``.

FL rounds are synchronous barriers, so round granularity is the natural
consistency point.  A checkpoint holds the global model, the round index
and JSON metadata (the sampler and telemetry RNG states, the placement
model's rows); array state that is not the model rides an ``.aux.npz``
sidecar.  Writes are crash-safe via write-to-temp + ``os.replace``;
``keep`` old checkpoints are retained for rollback.

The files are the reference's: a leaf's key in the npz is its path in the
tree, each step written as JAX's key types print (``['stem']`` for a dict
key, ``[0]`` for a sequence index, ``.name`` for a named-tuple field),
joined with ``/``.  So either package restores the other's checkpoints.

A bf16 leaf is written as the reference writes one: its 16 bits under the
``.npy`` descr ``<V2`` (what ``np.savez`` makes of an ``ml_dtypes``
bfloat16 array), byte for byte.  numpy reads that back as raw 2-byte
words with no cast to a float, so neither package restores such a leaf:
:func:`load_pytree` raises ``ValueError``, as the reference's does.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile

import numpy as np
import torch
from numpy.lib import format as npy_format

__all__ = ["save_pytree", "load_pytree", "CheckpointStore"]


def _leaves_with_paths(tree, prefix=()):
    """``[(key, leaf)]`` in JAX's flattening order: dict keys sorted,
    sequences and named tuples in order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves_with_paths(tree[k], prefix + (f"[{k!r}]",))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for name in tree._fields:
            out += _leaves_with_paths(getattr(tree, name),
                                      prefix + (f".{name}",))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves_with_paths(v, prefix + (f"[{i}]",))
        return out
    return [("/".join(prefix), tree)]


# A bf16 leaf's 16 bits, and the descr the reference's files give them.
_BITS16 = np.dtype("V2")
_BF16_DESCR = "<V2"


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BITS16)
        return t.numpy()
    return np.asarray(leaf)


def _savez(f, arrays: dict) -> None:
    """``np.savez(f, **arrays)``, with each 2-byte raw (bf16) array written
    under the descr ``<V2`` as the reference's files hold it (numpy would
    write ``|V2``)."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as member:
                if arr.dtype != _BITS16:
                    npy_format.write_array(member, arr)
                    continue
                npy_format.write_array_header_1_0(
                    member, {"descr": _BF16_DESCR, "fortran_order": False,
                             "shape": arr.shape})
                member.write(np.ascontiguousarray(arr).tobytes())


def _leaf_array(arrays: dict, key: str) -> np.ndarray:
    """The saved array of leaf ``key``; raw 2-byte words (a bf16 leaf)
    raise ``ValueError``: numpy has no cast from them to a number."""
    arr = np.asarray(arrays[key])
    if arr.dtype.kind == "V":
        raise ValueError(
            f"checkpoint leaf {key!r} holds raw {arr.dtype.itemsize}-byte "
            f"words (a bfloat16 leaf, saved as its bits): numpy has no cast "
            f"from them to a number, so it cannot be restored (the "
            f"reference's load_pytree raises on it too)")
    return arr


def _rebuild(like, arrays: dict, prefix=()):
    """``like``'s structure with each leaf read from ``arrays`` by its key,
    in the like leaf's dtype (a tensor for a tensor, on its device)."""
    if isinstance(like, dict):
        return {k: _rebuild(v, arrays, prefix + (f"[{k!r}]",))
                for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_rebuild(getattr(like, n), arrays,
                                     prefix + (f".{n}",))
                            for n in like._fields])
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, arrays, prefix + (f"[{i}]",))
                          for i, v in enumerate(like))
    key = "/".join(prefix)
    if key not in arrays:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    arr = _leaf_array(arrays, key)
    if torch.is_tensor(like):
        return torch.from_numpy(arr.copy()).to(like.device, like.dtype)
    return np.asarray(arr, dtype=np.asarray(like).dtype)


def save_pytree(path: str, tree) -> None:
    """Atomically save a tree's leaves (structure restored by example)."""
    arrays = {k: _to_numpy(v) for k, v in _leaves_with_paths(tree)}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            _savez(f, arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree(path: str, like):
    """Load leaves saved by :func:`save_pytree` into the structure of
    ``like``: tensors where ``like`` holds tensors, else numpy arrays."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    return _rebuild(like, arrays)


class CheckpointStore:
    """Directory of round checkpoints with a manifest and keep-k GC."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self.manifest_path = os.path.join(directory, "manifest.json")

    # -- manifest ------------------------------------------------------------
    def _read_manifest(self) -> dict:
        if not os.path.exists(self.manifest_path):
            return {"checkpoints": []}
        with open(self.manifest_path) as f:
            return json.load(f)

    def _write_json(self, obj, path: str, **kw) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".json.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, **kw)
        os.replace(tmp, path)

    def _entry(self, round_idx: int | None) -> dict:
        cs = self._read_manifest()["checkpoints"]
        if not cs:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        if round_idx is None:
            return cs[-1]
        matches = [c for c in cs if c["round"] == round_idx]
        if not matches:
            raise FileNotFoundError(f"no checkpoint for round {round_idx}")
        return matches[0]

    # -- save/restore --------------------------------------------------------
    def save(self, round_idx: int, params, *, extra: dict | None = None,
             aux=None) -> str:
        """Snapshot params + JSON-serializable extra state for a round.

        ``aux`` is an optional tree of arrays saved as a sibling
        ``.aux.npz`` (array state that is not the model — the compressed
        combine's error-feedback residuals).  Restored via
        :meth:`restore_aux`; absent for checkpoints that never had one."""
        name = f"round_{round_idx:08d}"
        pt_path = os.path.join(self.dir, name + ".npz")
        save_pytree(pt_path, params)
        if aux is not None:
            save_pytree(os.path.join(self.dir, name + ".aux.npz"), aux)
        meta = {"round": int(round_idx), "params": os.path.basename(pt_path),
                "extra": extra or {}}
        self._write_json(meta, os.path.join(self.dir, name + ".json"))
        m = self._read_manifest()
        m["checkpoints"] = [c for c in m["checkpoints"]
                            if c["round"] != round_idx]
        m["checkpoints"].append({"round": int(round_idx), "name": name})
        m["checkpoints"].sort(key=lambda c: c["round"])
        # keep-k garbage collection
        while len(m["checkpoints"]) > self.keep:
            old = m["checkpoints"].pop(0)
            for suffix in (".npz", ".json", ".aux.npz"):
                p = os.path.join(self.dir, old["name"] + suffix)
                if os.path.exists(p):
                    os.unlink(p)
        self._write_json(m, self.manifest_path, indent=1)
        return pt_path

    def latest_round(self) -> int | None:
        cs = self._read_manifest()["checkpoints"]
        return cs[-1]["round"] if cs else None

    def restore(self, like_params, *, round_idx: int | None = None):
        """Return (params, round, extra) for the requested/latest
        checkpoint, params in ``like_params``' structure."""
        name = self._entry(round_idx)["name"]
        with open(os.path.join(self.dir, name + ".json")) as f:
            meta = json.load(f)
        params = load_pytree(os.path.join(self.dir, name + ".npz"),
                             like_params)
        return params, meta["round"], meta.get("extra", {})

    def restore_aux(self, like, *, round_idx: int | None = None):
        """Load the ``.aux.npz`` sidecar for the requested/latest checkpoint
        into the structure of ``like``; None if that checkpoint has none."""
        path = os.path.join(self.dir,
                            self._entry(round_idx)["name"] + ".aux.npz")
        if not os.path.exists(path):
            return None
        return load_pytree(path, like)
