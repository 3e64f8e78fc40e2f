"""The port's sharding rules (``repro_torch/distributed/sharding.py``)
against the reference's (``repro/distributed/sharding.py`` and
``repro/launch/plan.py``'s ``_filter_spec``).

For every arch × policy × mesh — (1, 1), (2, 2), (16, 16) ("data",
"model") and (2, 16, 16) ("pod", "data", "model") — the port's spec of
every parameter leaf (``lm.param_shapes``) and of every cache leaf
(``lm.init_cache`` at the decode_32k and long_500k sizes) equals the
reference's, both as the rules give it and filtered by the leaf's shape.
The rules read only the mesh's axis names and the filter its axis sizes,
so no devices are needed.  Specs are pure logic: equal, no tolerance.
Also the shard/gather round trip and the local write on a meta mesh.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_arch as jget  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.launch import plan as jplan  # noqa: E402
from repro.models import init_cache as jinit_cache  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.distributed import sharding as tshard  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

POLICIES = ["tp", "fsdp_tp", "fsdp_tp_ep", "fsdp_tp_noep"]
MESHES = {"1x1": {"data": 1, "model": 1}, "2x2": {"data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CACHES = [(128, 32_768), (1, 524_288)]


def _flat(tree, prefix=""):
    """``{path: leaf}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jflat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def _param_shapes(arch):
    return jax.eval_shape(lambda k: jinit_params(k, jget(arch)),
                          jax.random.key(0))


@functools.lru_cache(maxsize=None)
def _cache_shapes(arch, batch, length):
    return jax.eval_shape(lambda: jinit_cache(jget(arch), batch, length))


def _check(jrules, trules, jshapes, tshapes, ax):
    jspecs = _jflat(jrules.tree_specs(jshapes))
    jleaves = _jflat(jshapes)
    tspecs = _flat(trules.tree_specs(tshapes))
    tleaves = _flat(tshapes)
    assert sorted(tspecs) == sorted(jspecs)
    for path, spec in tspecs.items():
        assert spec == tuple(jspecs[path]), path
        shape = tuple(getattr(tleaves[path], "shape", tleaves[path]))
        assert shape == tuple(jleaves[path].shape), path
        assert tshard.filter_spec(spec, shape, ax) == tuple(
            jplan._filter_spec(jspecs[path], shape, ax)), path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rules_match_reference(arch, policy, mesh):
    ax = MESHES[mesh]
    names = SimpleNamespace(axis_names=tuple(ax))
    for fl_axes in ((), ("data",), ("pod", "data")):
        jr = jshard.make_sharding_rules(policy, names, fl_axes=fl_axes)
        tr = tshard.make_sharding_rules(policy, ax, fl_axes=fl_axes)
        assert tr["policy"] == jr["policy"]
        assert tr["params"].axis_map == jr["params"].axis_map
        assert tr["kv"].axis_map == jr["kv"].axis_map
        _check(jr["params"], tr["params"], _param_shapes(arch),
               tlm.param_shapes(tget(arch)), ax)
        for batch, length in CACHES:
            _check(jr["kv"], tr["kv"], _cache_shapes(arch, batch, length),
                   tlm.init_cache(tget(arch), batch, length, device="meta"),
                   ax)
        assert tr["arrays"].spec_for_path("batches/tokens") == tuple(
            jr["arrays"].spec_for_path("batches/tokens"))


def test_unknown_policy_raises_in_both():
    names = SimpleNamespace(axis_names=("data", "model"))
    for make in (jshard.make_sharding_rules, tshard.make_sharding_rules):
        with pytest.raises(ValueError, match="unknown sharding policy"):
            make("dp", names)


FILTER_CASES = [
    ((None, "model"), (8, 12), {"model": 16}),            # 12 % 16
    (("data", "model"), (1, 32), {"data": 16, "model": 16}),
    ((("pod", "data"), None), (64, 3), {"pod": 2, "data": 16}),
    ((("pod", "data"), None), (16, 3), {"pod": 2, "data": 16}),
    ((("pod", "data"), "model"), (2, 1500), {"pod": 2, "data": 16,
                                            "model": 16}),
    (("data",), (7,), {"data": 1}),
    ((None, None, "model", None), (1, 2, 32_768, 8), {"model": 16}),
]


@pytest.mark.parametrize("spec,shape,ax", FILTER_CASES)
def test_filter_spec_matches_reference(spec, shape, ax):
    from jax.sharding import PartitionSpec as P
    assert tshard.filter_spec(spec, shape, ax) == tuple(
        jplan._filter_spec(P(*spec), shape, ax))


@pytest.mark.parametrize("spec", [("data", "model"), (("data", "model"),),
                                  (None, ("model", "data")), ()])
def test_shard_and_local_shape_on_every_rank(spec):
    """Every rank's slice has ``local_shape``, ``write_local`` of the whole
    leaf fills it with the same values, and the slices cover the leaf:
    placed at their blocks they rebuild it exactly."""
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    rebuilt = torch.zeros_like(x)
    for rank in range(4):
        mesh = make_mesh((2, 2), ("data", "model"), backend="meta",
                         device="cpu")
        mesh.rank = rank
        part = tshard.shard_leaf(x, spec, mesh)
        assert tuple(part.shape) == tshard.local_shape(x.shape, spec, mesh)
        assert tshard.global_shape(part.shape, spec, mesh) == tuple(x.shape)
        written = torch.zeros_like(part)
        tshard.write_local(written, x, spec, mesh, start=0, dim=1)
        assert torch.equal(written, part)
        _place(rebuilt, part, spec, mesh)
        assert torch.equal(part, _slice(x, spec, mesh))
    assert torch.equal(rebuilt, x)


def _slice(x, spec, mesh):
    for i, entry in enumerate(spec):
        idx, n = tshard._block(entry, mesh)
        b = x.shape[i] // n
        x = x.narrow(i, idx * b, b)
    return x


def _place(dst, part, spec, mesh):
    view = dst
    for i, entry in enumerate(spec):
        idx, n = tshard._block(entry, mesh)
        b = dst.shape[i] // n
        view = view.narrow(i, idx * b, b)
    view.copy_(part)


def test_write_local_writes_only_the_rank_s_slots():
    """A decode step's one new slot lands in the rank whose cache slice
    holds it, and nowhere else."""
    spec = (None, "model")
    for rank, want in ((0, False), (1, True)):
        mesh = make_mesh((1, 2), ("data", "model"), backend="meta",
                         device="cpu")
        mesh.rank = rank
        local = torch.zeros(3, 4)                  # slots 4 * rank + [0, 4)
        tshard.write_local(local, torch.ones(3, 1), spec, mesh, start=6)
        assert bool(local[:, 2].eq(1).all()) is want
        assert float(local.sum()) == (3.0 if want else 0.0)


def test_make_mesh_needs_a_named_backend():
    for bad in (None, "tpu"):
        with pytest.raises(ValueError, match="backend"):
            make_mesh((1, 1), ("data", "model"), backend=bad)
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1, 1), ("data", "model"), backend="gloo")
    mesh = make_mesh((2, 16, 16), ("pod", "data", "model"), backend="meta")
    assert mesh.size == 512 and mesh.coords == (0, 0, 0)
    assert np.prod(mesh.shape) == 512
