"""The port's expert-parallel dispatch (``repro_torch/distributed/
ep_dispatch.py``) on 4 gloo ranks of a (2, 2) ("data", "model") mesh on
the CPU, against the reference's ``make_ep_dispatch`` on a (2, 2) mesh of
4 host devices (a subprocess with ``--xla_force_host_platform_device_count
=4``, as ``tests/test_ep_dispatch.py`` runs it).

The same numpy inputs (x ``[4, 12, 32]``, 8 experts of width 16, top-2)
go to both, each rank given its shards: x split over ``data``, experts over
``model``, ``D`` over ``data`` (FSDP).  Cases: capacity factor 1.25
(drops; capacity per data shard), dropless (``E / k``), and 1.25 in
sequence chunks of 8 (the tail padded).  Tolerances, f32:

* outputs and the aux term against the reference: 1e-5;
* the gradients of ``Σ out·c + aux`` with respect to x, the router and
  each expert weight against the reference's ``jax.grad`` of its sharded
  dispatch: 1e-5;
* dropless, the outputs and the gradients of ``Σ out·c`` against the
  port's unsharded ``moe_layer_3d(impl="scatter")``: 1e-5 (the routing is
  the same; only the order of the k-sum over ranks differs);
* the collectives' own gradients (a loss counted once, not once per
  rank) and a one-rank mesh against ``"scatter"``: exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed.ep_dispatch import make_ep_dispatch  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_on_mesh  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

B, S, D, E, F, K = 4, 12, 32, 8, 16, 2
CASES = [(1.25, 0), (E / K, 0), (1.25, 8)]
IDS = ["cf1.25", "dropless", "cf1.25-chunk8"]
TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ("x", "router", "gate", "up", "down")
SPECS = {"x": ("data",), "router": (), "gate": ranks.GATE_SPEC,
         "up": ranks.GATE_SPEC, "down": ranks.DOWN_SPEC}

REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.distributed.ep_dispatch import make_ep_dispatch
a = dict(np.load(sys.argv[1]))
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
shard = lambda *s: NamedSharding(mesh, P(*s))
ins = (shard("data", None, None), shard(None, None),
       shard("model", "data", None), shard("model", "data", None),
       shard("model", None, "data"))
out = {}
for i, (cf, chunk) in enumerate(%(cases)r):
    disp = make_ep_dispatch(mesh, batch_axes=("data",), fsdp_axis="data",
                            seq_chunk=chunk)
    f = lambda x, r, g, u, d: disp(x, r, g, u, d, top_k=2,
                                   capacity_factor=cf)
    def loss(x, r, g, u, d):
        o, aux = f(x, r, g, u, d)
        return (o * a["c"]).sum() + aux
    args = [jnp.asarray(a[k]) for k in ("x", "router", "gate", "up", "down")]
    o, aux = jax.jit(f, in_shardings=ins)(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)),
                    in_shardings=ins)(*args)
    out[f"{i}/out"], out[f"{i}/aux"] = np.asarray(o), np.asarray(aux)
    for k, g in zip(("x", "router", "gate", "up", "down"), grads):
        out[f"{i}/g_{k}"] = np.asarray(g)
np.savez(sys.argv[2], **out)
print("OK")
""" % {"cases": CASES}


def _arrays():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((B, S, D)).astype(np.float32),
            "router": (rng.standard_normal((D, E)) * 0.1).astype(np.float32),
            "gate": (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32),
            "up": (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32),
            "down": (rng.standard_normal((E, F, D)) * 0.1).astype(np.float32),
            "c": rng.standard_normal((B, S, D)).astype(np.float32)}


@pytest.fixture(scope="module")
def arrays():
    return _arrays()


@pytest.fixture(scope="module")
def reference(arrays, tmp_path_factory):
    d = tmp_path_factory.mktemp("ep_ref")
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "in.npz"),
                          str(d / "out.npz")], env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def ranks_out(arrays):
    """Each rank's result, keyed by its (data, model) coords."""
    res = run_on_mesh(ranks.ep_rank, (2, 2), ("data", "model"),
                      backend="gloo", device="cpu",
                      args=(arrays, CASES), timeout_s=300)
    return {r["coords"]: r for r in res}


def _assemble(parts: dict, spec) -> np.ndarray:
    """The whole array from the ranks' slices under ``spec`` (over a (2, 2)
    ("data", "model") mesh)."""
    def block(d, m):
        return parts[(d, m)].detach().numpy()
    dims = {a: i for i, a in enumerate(spec) if a is not None}
    if not dims:
        return block(0, 0)
    rows = []
    for d in range(2):
        cols = [block(d, m) for m in range(2)]
        rows.append(np.concatenate(cols, axis=dims["model"])
                    if "model" in dims else cols[0])
    return np.concatenate(rows, axis=dims["data"]) if "data" in dims \
        else rows[0]


def _grad(ranks_out, case, loss, name):
    parts = {c: r["cases"][case][f"grad_{loss}"][name]
             for c, r in ranks_out.items()}
    if name in ("x", "router"):
        # x: replicated over model; the router over both: every copy equal.
        for (d, m), g in parts.items():
            assert torch.equal(g, parts[(d, 0)] if name == "x"
                               else parts[(0, 0)])
    return _assemble(parts, SPECS[name])


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_dispatch_matches_reference(case, reference, ranks_out):
    outs = {c: r["cases"][case]["out"] for c, r in ranks_out.items()}
    for (d, m), o in outs.items():
        assert torch.equal(o, outs[(d, 0)])        # replicated over model
    np.testing.assert_allclose(_assemble(outs, ("data",)),
                               reference[f"{case}/out"], **TOL)
    auxs = [float(r["cases"][case]["aux"]) for r in ranks_out.values()]
    assert len(set(auxs)) == 1                      # pmean'd over data
    np.testing.assert_allclose(auxs[0], reference[f"{case}/aux"], **TOL)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_grads_match_reference(case, name, reference, ranks_out):
    """``Σ out·c + aux``: the shard_map gradient, aux term included."""
    np.testing.assert_allclose(_grad(ranks_out, case, "aux", name),
                               reference[f"{case}/g_{name}"], **TOL)


@pytest.fixture(scope="module")
def unsharded(arrays):
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in arrays.items()
         if k != "c"}
    out, _ = tlayers.moe_layer_3d(t["x"], t["router"], t["gate"], t["up"],
                                  t["down"], top_k=K, capacity_factor=E / K,
                                  impl="scatter")
    (out * torch.from_numpy(arrays["c"])).sum().backward()
    return {"out": out.detach().numpy(),
            **{k: v.grad.numpy() for k, v in t.items()}}


@pytest.mark.parametrize("name", NAMES)
def test_dropless_grads_equal_unsharded_scatter(name, unsharded, ranks_out):
    """Dropless, local routing is global routing: the gradients of ``Σ
    out·c`` are the unsharded dispatch's, and so are the outputs."""
    case = IDS.index("dropless")
    np.testing.assert_allclose(_grad(ranks_out, case, "out", name),
                               unsharded[name], **TOL)
    outs = {c: r["cases"][case]["out"] for c, r in ranks_out.items()}
    np.testing.assert_allclose(_assemble(outs, ("data",)), unsharded["out"],
                               **TOL)


def test_collective_gradients_count_a_loss_once(ranks_out):
    """``psum``: a replicated result's loss counts once (gradient 1, not
    the rank count); ``pmean``: 1/n; ``all_gather``: the ranks' cotangents
    summed, this rank's slice kept."""
    for (d, m), r in ranks_out.items():
        c = r["collectives"]
        assert torch.equal(c["psum_grad"], torch.ones(3))
        assert torch.equal(c["pmean_grad"], torch.full((3,), 0.5))
        assert torch.equal(c["psum"], torch.full((3,), float(2 * d + 1)))
        # all_gather over model of [m, m]: the loss Σ w·y with w = 1..4
        # on every rank: each rank's slice gets 2 × its weights.
        assert torch.equal(c["gather"], torch.tensor(
            [2 * d, 2 * d, 2 * d + 1, 2 * d + 1], dtype=torch.float32))
        assert torch.equal(c["gather_grad"],
                           2 * torch.tensor([1.0, 2.0]) + 4 * m)


def _one_rank_scatter(mesh, arrays):
    """On a (1, 1) mesh: the dispatch and ``moe_layer_3d("scatter")`` on
    the same whole inputs, with and without sequence chunks."""
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    out = []
    for chunk in (0, 8):
        disp = make_ep_dispatch(mesh, batch_axes=("data",), fsdp_axis="data",
                                seq_chunk=chunk)
        got = disp(t["x"], t["router"], t["gate"], t["up"], t["down"],
                   top_k=K, capacity_factor=1.25)
        want = tlayers.moe_layer_3d(t["x"], t["router"], t["gate"], t["up"],
                                    t["down"], top_k=K, capacity_factor=1.25,
                                    impl="scatter", seq_chunk=chunk)
        out.append((got, want))
    return out


def test_one_rank_mesh_is_scatter_bitwise(arrays):
    """At model size 1 every expert is local and the collectives return
    their operands: the dispatch is ``"scatter"``, bit for bit."""
    (res,) = run_on_mesh(_one_rank_scatter, (1, 1), ("data", "model"),
                         backend="gloo", device="cpu", args=(arrays,),
                         timeout_s=120)
    for (got, want) in res:
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


def test_meta_mesh_records_the_dispatch_s_collectives():
    """On a (16, 16) meta mesh one dispatch records the FSDP gathers of its
    three expert weights over ``data`` and the psum over ``model`` plus the
    aux term's over ``data``, with the ring formulas' wire bytes."""
    mesh = make_mesh((16, 16), ("data", "model"), backend="meta")
    disp = make_ep_dispatch(mesh, batch_axes=("data",), fsdp_axis="data")
    x = torch.empty(2, 64, 256, device="meta")
    w = torch.empty(2, 16, 128, device="meta")             # [E_loc, D/16, F]
    seen = []
    with coll.counting(seen.append):
        out, aux = disp(x, torch.empty(256, 32, device="meta"), w, w,
                        torch.empty(2, 128, 16, device="meta"), top_k=2,
                        capacity_factor=1.25)
    assert out.shape == x.shape and out.device.type == "meta"
    kinds = [(c.kind, c.axis) for c in seen]
    assert kinds == [("all-gather", "data")] * 3 + [
        ("all-reduce", "model"), ("all-reduce", "data")]
    gather = 2 * 256 * 128 * 4
    assert seen[0].bytes == gather
    assert seen[0].wire_bytes == gather * 15 / 16
    assert seen[3].wire_bytes == 2 * (2 * 64 * 256 * 4) * 15 / 16
