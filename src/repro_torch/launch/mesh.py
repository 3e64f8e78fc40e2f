"""Meshes of ranks, and the shard → device binding of the FL mesh path —
port of ``repro/launch/mesh.py``.

A :class:`Mesh` lays ``torch.distributed`` ranks out on named axes, as the
reference lays chips out on a ``jax.sharding.Mesh``:

  single-pod : (16, 16)    axes ("data", "model")
  multi-pod  : (2, 16, 16) axes ("pod", "data", "model")

(:func:`make_production_mesh`).  One client's weights and activations are
split over it (:mod:`repro_torch.distributed.sharding`,
:mod:`repro_torch.distributed.collectives`).  The backend is always named
by the caller:

* ``"nccl"`` — each rank owns a card;
* ``"gloo"`` — ranks share a card or run on the CPU (NCCL refuses two ranks
  on one card); CUDA tensors cross through the host;
* ``"meta"`` — counting only: no process group, every rank's view is rank
  0's, and each collective returns a meta tensor of its result's shape and
  records its wire bytes (:func:`repro_torch.distributed.collectives
  .counting`).

:func:`run_on_mesh` spawns one process per rank (CUDA cannot fork), joins
them with a deadline, and fails as a whole when any rank fails.

``fl_shard_devices`` and ``fl_combine_topology`` bind the engine's FL
worker shards to devices: shard ``s`` runs on ``cuda:(s % device_count)``;
the combine root is shard 0's device.  On one card every shard and the root
are ``cuda:0``, as in the reference's single-device case; an engine on the
CPU maps every shard to the CPU.
"""

from __future__ import annotations

import io
import math
import socket
import time
import traceback
from dataclasses import dataclass, field

import torch

__all__ = ["Mesh", "make_mesh", "sub_mesh", "make_test_mesh",
           "make_production_mesh", "axis_sizes", "run_on_mesh", "free_port",
           "fl_shard_devices", "fl_combine_topology", "BACKENDS"]

BACKENDS = ("nccl", "gloo", "meta")


@dataclass
class Mesh:
    """Ranks on named axes, row-major: rank ``r`` sits at
    ``coords = unravel(r, shape)``.  ``groups`` maps each axis to this
    rank's process group along it (``None`` on a meta mesh)."""

    shape: tuple
    axis_names: tuple
    backend: str
    device: torch.device
    rank: int = 0
    groups: dict = field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def coords(self) -> tuple:
        out, r = [], self.rank
        for n in reversed(self.shape):
            out.append(r % n)
            r //= n
        return tuple(reversed(out))

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    @property
    def meta(self) -> bool:
        return self.backend == "meta"


def axis_sizes(mesh) -> dict:
    """``{axis: size}`` of a :class:`Mesh`, or a copy of such a dict."""
    if isinstance(mesh, Mesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(mesh)


def make_mesh(shape, axes, *, backend: str | None = None,
              device=None) -> Mesh:
    """A mesh of ``shape`` over ``axes``.  ``"nccl"`` and ``"gloo"`` need
    ``torch.distributed`` initialised with ``prod(shape)`` ranks; every rank
    must build the same meshes in the same order (each axis makes one
    process group per line of ranks along it; :func:`sub_mesh` makes a
    smaller mesh on the same ranks).  ``device`` is where this
    rank computes (default: ``meta`` on a meta mesh, else ``cuda``)."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if backend not in BACKENDS:
        raise ValueError(f"make_mesh needs backend= one of {BACKENDS}, got "
                         f"{backend!r}: nccl when each rank owns a card, "
                         f"gloo when ranks share one or run on the CPU, meta "
                         f"for counting")
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if backend == "meta":
        return Mesh(shape, axes, backend, torch.device(device or "meta"))
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(f"a {backend} mesh needs torch.distributed "
                           f"initialised (init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"process group has {world}")
    return _with_groups(Mesh(shape, axes, backend,
                             torch.device(device or "cuda"), rank))


def sub_mesh(mesh: Mesh, shape) -> Mesh | None:
    """The first ``prod(shape)`` ranks of ``mesh`` laid out row-major on
    ``shape`` over the same axes, with groups of their own; ``None`` on the
    ranks left out.  Every rank of ``mesh`` calls it, in the same order (a
    process group is made by all ranks), so one set of spawned ranks can
    serve meshes of several shapes."""
    shape = tuple(int(n) for n in shape)
    if shape == tuple(mesh.shape):
        return mesh
    if len(shape) != len(mesh.shape) or math.prod(shape) > mesh.size:
        raise ValueError(f"sub_mesh {shape} does not fit mesh {mesh.shape}")
    sub = _with_groups(Mesh(shape, mesh.axis_names, mesh.backend,
                            mesh.device, mesh.rank))
    return sub if mesh.rank < sub.size else None


def _with_groups(mesh: Mesh) -> Mesh:
    """``mesh`` with one process group per line of ranks along each axis
    (ranks ``0 .. mesh.size - 1``, row-major); this rank keeps its own."""
    import torch.distributed as dist
    ranks = torch.arange(mesh.size).reshape(mesh.shape)
    for i, axis in enumerate(mesh.axis_names):
        lines = ranks.movedim(i, -1).reshape(-1, mesh.shape[i])
        for line in lines.tolist():
            group = dist.new_group(line, backend=mesh.backend)
            if mesh.rank in line:
                mesh.groups[axis] = group
    return mesh


def make_test_mesh(shape=(1, 1), axes=("data", "model"), *,
                   backend: str | None = None, device=None) -> Mesh:
    """A small mesh (tests, the card's two-rank runs)."""
    return make_mesh(shape, axes, backend=backend, device=device)


def make_production_mesh(*, multi_pod: bool = False,
                         backend: str | None = None, device=None) -> Mesh:
    """The reference's production meshes: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, backend=backend, device=device)


def free_port() -> int:
    """A free TCP port on localhost (the rendezvous of spawned ranks)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_bytes(obj) -> bytes:
    """``obj`` serialised with its tensors copied to the host: a rank's
    result must outlive the rank (a tensor sent as it is would be shared
    memory the rank frees at exit)."""
    from torch.utils._pytree import tree_map
    buf = io.BytesIO()
    torch.save(tree_map(lambda t: t.detach().cpu()
                        if isinstance(t, torch.Tensor) else t, obj), buf)
    return buf.getvalue()


def _rank_main(conn, rank, world, port, backend, shape, axes, device, fn,
               args, timeout_s, go):
    """Spawn target: join the process group, build the mesh, wait for
    ``go`` (if any), run ``fn(mesh, *args)``, send ``("ok", result)`` or
    ``("err", trace)``."""
    import datetime

    import torch.distributed as dist
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is not None:
                torch.cuda.set_device(dev)
            from repro_torch.launch.train import set_deterministic
            set_deterministic()
        else:
            # Ranks on the CPU share its cores: one thread each.
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            mesh = make_mesh(shape, axes, backend=backend, device=device)
            if go is not None:
                go.wait()
            conn.send(("ok", _to_bytes(fn(mesh, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent
        conn.send(("err", traceback.format_exc()))
    finally:
        conn.close()


def run_on_mesh(fn, shape, axes, *, backend: str, device="cuda",
                args: tuple = (), timeout_s: float = 600.0,
                meanwhile=None) -> list:
    """Run ``fn(mesh, *args)`` on ``prod(shape)`` spawned ranks and return
    their results in rank order.  ``fn`` and ``args`` must be picklable
    (``fn`` a module-level function).  A rank that raises, dies or is not
    done within ``timeout_s`` fails the run: the others are killed and a
    ``RuntimeError`` names it.  Every rank computes on ``device``.

    With ``meanwhile``, this process calls ``meanwhile()`` once the ranks
    are started, and they call ``fn`` only after it has returned: their
    start-up (seconds a process on a card) overlaps it, and it may prepare
    what they read.  If it raises, the ranks are killed."""
    import multiprocessing as mp
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"run_on_mesh spawns nccl or gloo ranks, not "
                         f"{backend!r}")
    world = math.prod(shape)
    ctx = mp.get_context("spawn")
    port = free_port()
    go = None if meanwhile is None else ctx.Event()
    procs, conns = [], []
    for rank in range(world):
        parent_c, child_c = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_rank_main, name=f"mesh-rank{rank}",
                        args=(child_c, rank, world, port, backend,
                              tuple(shape), tuple(axes), str(device), fn,
                              tuple(args), timeout_s, go), daemon=True)
        p.start()
        child_c.close()
        procs.append(p)
        conns.append(parent_c)
    results: dict = {}
    error = None
    try:
        if meanwhile is not None:
            error = "meanwhile raised"     # the ranks are killed below
            meanwhile()
            error = None
            go.set()
        deadline = time.monotonic() + timeout_s
        while len(results) < world and error is None:
            left = deadline - time.monotonic()
            if left <= 0:
                error = f"ranks {sorted(set(range(world)) - set(results))} " \
                        f"not done within {timeout_s} s"
                break
            for rank, c in enumerate(conns):
                if rank in results or not c.poll(min(left, 0.2)):
                    if rank not in results and not procs[rank].is_alive() \
                            and not c.poll():
                        error = (f"rank {rank} died (exit code "
                                 f"{procs[rank].exitcode})")
                        break
                    continue
                try:
                    tag, val = c.recv()
                except EOFError:
                    error = f"rank {rank} closed its pipe"
                    break
                if tag == "err":
                    error = f"rank {rank} raised:\n{val}"
                    break
                results[rank] = torch.load(io.BytesIO(val),
                                           weights_only=False)
    finally:
        for p in procs:
            if error is not None and p.is_alive():
                p.kill()
            p.join(timeout=30.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        for c in conns:
            c.close()
    if error is not None:
        raise RuntimeError(f"run_on_mesh {tuple(shape)} {backend}: {error}")
    return [results[r] for r in range(world)]


def fl_shard_devices(n_shards: int, device="cuda") -> list:
    """One device per shard, cycled over the cards of ``device``'s type."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_shards
    count = torch.cuda.device_count()
    return [torch.device("cuda", s % count) for s in range(n_shards)]


def fl_combine_topology(n_shards: int, device="cuda") -> tuple:
    """``(shard_devices, root)``: shard ``s``'s merge runs on
    ``shard_devices[s]``, where its partials already live; the cross-shard
    combine runs on ``root`` (shard 0's device)."""
    devs = fl_shard_devices(n_shards, device)
    return devs, devs[0]
