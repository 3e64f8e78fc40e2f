"""The port's mesh path — per-worker programs, the flat, tree, host and
compressed combines — against the JAX reference and against its own
fused path.

Size: the reference's mesh tests' (``tests/test_mesh.py``): SR input 16,
width 32, 2 blocks, 64 clients, batch 4, cohort 8 over 4 workers × 2
lanes, ``steps_cap`` 4, SGD lr 0.1 momentum 0.9.  Parity tests hand the
reference's dataset and initial weights to both engines.

Tolerances, and why:

* the shard maps and the pairwise tree are pure logic: exact;
* the round functions train through GEMMs whose sums the two libraries
  order differently, and the combines do the reference's f32 ops in its
  order up to XLA's contraction: rtol 1e-5, atol 1e-6;
* inside the port, the decomposition changes no lane's arithmetic: the
  flat mesh at 2 and 4 shards is bitwise equal to the fused path at every
  depth and bucket mode, the tree and compressed combines are bitwise
  across depths and bucket modes, ``hosts`` 1/2/4 bitwise; the tree
  re-associates the cross-lane mean, so it matches flat to rtol 1e-5;
* port against reference, compressed: the shard partials of the two
  frameworks differ in the last bits, so an int8 code can move by one at
  a rounding edge and top-k can pick another entry at a near tie — losses
  within rtol 1e-4 over 3 rounds (measured: at most 3.6e-6).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _torch_parity import one_intra_op_thread  # noqa: E402,F401
from repro.compress import make_encode_step as jencode  # noqa: E402
from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.core import FederatedEngine as JEngine  # noqa: E402
from repro.core import SyntheticTelemetry as JTelemetry  # noqa: E402
from repro.core import UniformSampler as JSampler  # noqa: E402
from repro.core import make_placement as jplacement  # noqa: E402
from repro.data import make_federated_dataset as jdataset  # noqa: E402
from repro.data.batching import build_round_arrays  # noqa: E402
from repro.distributed import WorkerPool as JPool  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.fl import round as jround  # noqa: E402
from repro.models.papertasks import make_task_model as jmodel  # noqa: E402
from repro.core.placement import ClientInfo, RoundRobinPlacement  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.core import EngineConfig as TConfig  # noqa: E402
from repro_torch.core import FederatedEngine as TEngine  # noqa: E402
from repro_torch.core import SyntheticTelemetry as TTelemetry  # noqa: E402
from repro_torch.core import UniformSampler as TSampler  # noqa: E402
from repro_torch.core import ZipfSampler as TZipf  # noqa: E402
from repro_torch.core import make_placement as tplacement  # noqa: E402
from repro_torch.data import make_federated_dataset as tdataset  # noqa: E402
from repro_torch.distributed import WorkerPool as TPool  # noqa: E402
from repro_torch.distributed import sharding as tshard  # noqa: E402
from repro_torch.fl import round as tround  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.papertasks import TASK_MODELS  # noqa: E402
from repro_torch.models.papertasks import make_task_model as tmodel  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402

SMALL = dict(input_dim=16, width=32, n_blocks=2)
TOL = dict(rtol=1e-5, atol=1e-6)
DS_KW = dict(n_clients=64, input_dim=16, batch_size=4, size_mu=2.5,
             size_sigma=0.8)


@functools.lru_cache(maxsize=None)
def _ref_dataset():
    return jdataset("sr", **DS_KW)


@functools.lru_cache(maxsize=None)
def _ref_params():
    p, _ = jmodel("sr", jax.random.key(0), **SMALL)
    return {k: np.asarray(v) for k, v in p.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in tree.items()}


def _hetero_specs():
    """Two fast + two slow workers (``tests/test_mesh.py:55-61``)."""
    return [("a40", 1.0, 2), ("a40", 1.0, 2), ("2080ti", 0.35, 2),
            ("2080ti", 0.35, 2)]


def _port_engine(*, depth=1, ref_inputs=False, hetero=False, zipf=False,
                 steps_cap=4, **cfg):
    if ref_inputs:
        ds, params = _ref_dataset(), _torch(_ref_params())
    else:
        ds = tdataset("sr", **DS_KW)
        params, _ = tmodel("sr", 0, device="cpu", **SMALL)
    pool = (TPool.from_specs(_hetero_specs()) if hetero
            else TPool.homogeneous(4, type_name="a40", concurrency=2))
    return TEngine(
        dataset=ds, loss_fn=TASK_MODELS["sr"].loss_fn, init_params=params,
        optimizer=tsgd(0.1, momentum=0.9), placement=tplacement("lb"),
        sampler=TZipf(64, 8, a=1.2) if zipf else TSampler(64, 8),
        pool=pool, telemetry=TTelemetry(),
        config=TConfig(steps_cap=steps_cap, batch_size=4, lanes_per_worker=2,
                       pipeline_depth=depth, **cfg),
        device="cpu")


def _ref_engine(**cfg):
    _, loss = jmodel("sr", jax.random.key(0), **SMALL)
    return JEngine(
        dataset=_ref_dataset(), loss_fn=loss,
        init_params=jax.tree.map(jnp.asarray, _ref_params()),
        optimizer=jsgd(0.1, momentum=0.9), placement=jplacement("lb"),
        sampler=JSampler(64, 8),
        pool=JPool.homogeneous(4, type_name="a40", concurrency=2),
        telemetry=JTelemetry(),
        config=JConfig(steps_cap=4, batch_size=4, lanes_per_worker=2,
                       pipeline_depth=1, **cfg))


@functools.lru_cache(maxsize=None)
def _port_run(rounds=4, **cfg):
    """(losses, combine_bytes, padded_steps) of a port run, cached: several
    tests compare against the same run."""
    res = _port_engine(**cfg).run(rounds)
    return ([r.loss for r in res], [r.combine_bytes for r in res],
            [r.padded_steps for r in res])


@functools.lru_cache(maxsize=None)
def _ref_run(rounds, **cfg):
    res = _ref_engine(**cfg).run(rounds)
    return [r.loss for r in res], [r.combine_bytes for r in res]


# -- shard maps, pairwise tree, devices --------------------------------------
def test_worker_shard_map_matches_the_reference():
    workers = TPool.from_specs([("a40", 1.0, 2)] * 7).snapshot()
    workers = [w for w in workers if w.wid != 3]          # a churned wid
    for k in (1, 2, 3, 4):
        for devices in (None, ["d0", "d1"]):
            t = tshard.WorkerShardMap.build(workers, k, devices=devices)
            j = jshard.WorkerShardMap.build(workers, k, devices=devices)
            assert t.shard_of_wid == j.shard_of_wid and t.devices == j.devices
            assert t.live_shards() == j.live_shards()
            assert t.merge_groups() == j.merge_groups()
            for wid in range(9):
                assert t.shard_of(wid) == j.shard_of(wid)
                assert t.device_for(wid) == j.device_for(wid)
    for mod in (tshard, jshard):
        with pytest.raises(ValueError, match="n_shards"):
            mod.WorkerShardMap.build(workers, 0)


@pytest.mark.parametrize("k,h", [(8, 2), (4, 4), (6, 1), (12, 1), (4, 3),
                                 (6, 2), (4, 0), (0, 1)])
def test_host_shard_map_matches_the_reference(k, h):
    try:
        j = jshard.HostShardMap.build(k, h)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tshard.HostShardMap.build(k, h)
        assert str(got.value) == str(e)
        return
    t = tshard.HostShardMap.build(k, h)
    assert (t.n_hosts, t.n_shards, t.block) == (j.n_hosts, j.n_shards, j.block)
    assert [t.host_of(s) for s in range(k)] == [j.host_of(s) for s in range(k)]
    assert [list(t.shards_of(x)) for x in range(h)] == \
        [list(j.shards_of(x)) for x in range(h)]


def test_pairwise_reduce_matches_the_reference():
    """Same tree shape for every hole pattern: the recorded merge order is
    the reduction's association."""
    rng = np.random.default_rng(0)

    def merge(a, b):
        return ("+", a, b)

    for n in range(0, 10):
        for _ in range(6):
            slots = [None if rng.random() < 0.3 else f"s{i}"
                     for i in range(n)]
            assert tshard.HostShardMap.pairwise_reduce(slots, merge) == \
                jshard.HostShardMap.pairwise_reduce(slots, merge)


def test_shard_devices_on_the_cpu():
    devs, root = tmesh.fl_combine_topology(3, "cpu")
    assert devs == [torch.device("cpu")] * 3 and root == torch.device("cpu")
    with pytest.raises(ValueError, match="n_shards"):
        tmesh.fl_shard_devices(0, "cpu")


# -- the six round functions ---------------------------------------------------
def _arrays(cids=(0, 1, 2, 3, 5, 8)):
    ds = _ref_dataset()
    workers = JPool.homogeneous(2, type_name="a40", concurrency=2).snapshot()
    clients = [ClientInfo(cid=c, n_batches=ds.n_batches(c),
                          n_samples=ds.n_samples(c)) for c in cids]
    asg = RoundRobinPlacement().assign(clients, workers)
    return build_round_arrays(ds, asg, workers, lanes_per_worker=2,
                              steps_cap=4, batch_size=4)


def _close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k])
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _rand(shape, seed, lo=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, 5.0, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _lead_tree(lead, seed):
    return {k: _rand(lead + v.shape, seed + i)
            for i, (k, v) in enumerate(sorted(_ref_params().items()))}


def test_worker_step_matches_the_reference():
    a = _arrays()
    blk = slice(1, 2)                    # worker 1's [1, P, S] block
    args = [{k: v[blk] for k, v in a.batches.items()}, a.step_mask[blk],
            a.boundary[blk], a.weight[blk]]
    _, jloss = jmodel("sr", jax.random.key(0), **SMALL)
    jstep = jround.make_worker_round_step(jloss, jsgd(0.1, momentum=0.9))
    want = jstep(jax.tree.map(jnp.asarray, _ref_params()),
                 *jax.tree.map(jnp.asarray, args))
    tstep = tround.make_worker_round_step(TASK_MODELS["sr"].loss_fn,
                                          tsgd(0.1, momentum=0.9))
    got = tstep(_torch(_ref_params()), _torch(args[0]),
                *[torch.from_numpy(x) for x in args[1:]])
    for g, w in zip(got, want):
        _close(g, w)
    assert float(got[1].sum()) > 0            # it folded clients


def test_combine_step_matches_the_reference():
    g = _ref_params()
    theta, n = _lead_tree((4, 2), 10), _rand((4, 2), 1, lo=0.0)
    n[1, 1] = 0.0
    ls = _rand((4, 2), 2)
    masks = [(_rand((4, 2, 5), s) > 0).astype(np.float32) for s in (3, 4)]
    masks.append(_rand((4, 2, 5), 5, lo=0.0) * masks[1])
    jnew, jm = jround.make_combine_step()(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, theta),
        jnp.asarray(n), jnp.asarray(ls), *map(jnp.asarray, masks))
    tnew, tm = tround.make_combine_step()(
        _torch(g), _torch(theta), torch.from_numpy(n), torch.from_numpy(ls),
        *map(torch.from_numpy, masks))
    _close(tnew, jnew)
    for a, b in zip(tm, jm):
        _close(a, b)


def test_shard_merge_and_host_node_match_the_reference():
    theta, n, ls = _lead_tree((2, 2), 20), _rand((2, 2), 6, lo=0.0), \
        _rand((2, 2), 7)
    n[0, 1] = 0.0
    jm = jround.make_shard_merge_step()(jax.tree.map(jnp.asarray, theta),
                                        jnp.asarray(n), jnp.asarray(ls))
    tm = tround.make_shard_merge_step()(_torch(theta), torch.from_numpy(n),
                                        torch.from_numpy(ls))
    for a, b in zip(tm, jm):
        _close(a, b)
    ta, tb = _lead_tree((), 30), _lead_tree((), 40)
    jn = jround.make_host_node_merge_step()(
        jax.tree.map(jnp.asarray, ta), jnp.float32(3.0), jnp.float32(0.5),
        jax.tree.map(jnp.asarray, tb), jnp.float32(5.0), jnp.float32(0.25))
    tn = tround.make_host_node_merge_step()(
        _torch(ta), torch.tensor(3.0), torch.tensor(0.5),
        _torch(tb), torch.tensor(5.0), torch.tensor(0.25))
    for a, b in zip(tn, jn):
        _close(a, b)


def _payloads(mode, k):
    """k shard payloads encoded by the reference, as (jax, torch) stacks."""
    g = _ref_params()
    enc = jencode(mode, 0.1)
    pays = [enc(jax.tree.map(jnp.asarray, g),
                jax.tree.map(jnp.asarray, _lead_tree((), 50 + s)),
                jax.tree.map(jnp.zeros_like, g))[0] for s in range(k)]
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *pays)

    def conv(x):
        return torch.from_numpy(np.array(x, copy=True))

    if mode == "int8":
        tstack = ({k_: conv(v) for k_, v in jstack[0].items()},
                  {k_: conv(v) for k_, v in jstack[1].items()})
        tone = ({k_: conv(v) for k_, v in pays[0][0].items()},
                {k_: conv(v) for k_, v in pays[0][1].items()})
    else:
        tstack = {k_: (conv(i), conv(v)) for k_, (i, v) in jstack.items()}
        tone = {k_: (conv(i), conv(v)) for k_, (i, v) in pays[0].items()}
    return pays[0], jstack, tone, tstack


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_decode_step_matches_the_reference(mode):
    g = _ref_params()
    jone, _, tone, _ = _payloads(mode, 1)
    want = jround.make_payload_decode_step(mode)(
        jax.tree.map(jnp.asarray, g), jone)
    got = tround.make_payload_decode_step(mode)(_torch(g), tone)
    _close(got, want)


@pytest.mark.parametrize("mode,jimpl", [("int8", "xla"), ("int8", "pallas"),
                                        ("topk", "xla")])
def test_compressed_combine_step_matches_the_reference(mode, jimpl):
    g = _ref_params()
    _, jstack, _, tstack = _payloads(mode, 3)
    n = np.asarray([4.0, 0.0, 6.0], np.float32)
    ls = _rand((3,), 8)
    masks = [np.ones((2, 2, 3), np.float32)] * 3
    jnew, jm = jround.make_compressed_combine_step(mode, agg_impl=jimpl)(
        jax.tree.map(jnp.asarray, g), jstack, jnp.asarray(n),
        jnp.asarray(ls), *map(jnp.asarray, masks))
    tnew, tm = tround.make_compressed_combine_step(mode)(
        _torch(g), tstack, torch.from_numpy(n), torch.from_numpy(ls),
        *map(torch.from_numpy, masks))
    _close(tnew, jnew)
    for a, b in zip(tm, jm):
        _close(a, b)


# -- the engine, inside the port ------------------------------------------------
@pytest.mark.parametrize("mesh", [2, 4])
@pytest.mark.parametrize("bucket", ["round", "worker"])
@pytest.mark.parametrize("depth", [0, 1])
def test_flat_mesh_is_bitwise_the_fused_path(mesh, bucket, depth):
    fused, _, fused_padded = _port_run()
    losses, nbytes, padded = _port_run(mesh_workers=mesh, bucket_mode=bucket,
                                       depth=depth)
    assert losses == fused
    assert all(b > 0 for b in nbytes)
    if bucket == "round":
        assert padded == fused_padded


def test_tree_is_depth_and_bucket_invariant_and_close_to_flat():
    tree, tbytes, _ = _port_run(mesh_workers=4, combine_mode="tree")
    for kw in (dict(depth=0), dict(bucket_mode="worker")):
        assert _port_run(mesh_workers=4, combine_mode="tree", **kw)[0] == tree
    flat, fbytes, _ = _port_run(mesh_workers=4)
    np.testing.assert_allclose(tree, flat, rtol=1e-5)
    # flat ships every lane partial (4 workers x 2 lanes), tree one per shard
    assert fbytes == [2 * b for b in tbytes]


@pytest.mark.parametrize("compress", ["none", "int8"])
def test_hosts_are_bitwise_across_host_counts(compress):
    runs = {h: _port_run(mesh_workers=4, combine_mode="tree",
                         combine_compress=compress, hosts=h)
            for h in (1, 2, 4)}
    assert runs[1][0] == runs[2][0] == runs[4][0]
    # the host->root hop ships one partial per live host: O(hosts)
    assert runs[2][1] == [2 * b for b in runs[1][1]]
    assert runs[4][1] == [4 * b for b in runs[1][1]]


@pytest.mark.parametrize("compress", ["int8", "topk"])
def test_compressed_losses_are_depth_and_bucket_invariant(compress):
    kw = dict(mesh_workers=2, combine_mode="tree", combine_compress=compress)
    base = _port_run(**kw, depth=0)[0]
    assert _port_run(**kw, depth=1)[0] == base
    assert _port_run(**kw, bucket_mode="worker")[0] == base
    assert all(np.isfinite(base))
    exact = _port_run(mesh_workers=2, combine_mode="tree")[0]
    assert base[0] == exact[0]        # round 0 trains on identical params


def test_worker_buckets_cut_padded_steps_on_a_heterogeneous_pool():
    kw = dict(mesh_workers=2, hetero=True, zipf=True, steps_cap=16)
    rnd = _port_engine(bucket_mode="round", **kw)
    wrk = _port_engine(bucket_mode="worker", **kw)
    r_round, r_worker = rnd.run(4), wrk.run(4)
    assert [r.loss for r in r_worker] == [r.loss for r in r_round]
    assert sum(r.padded_steps for r in r_worker) < \
        sum(r.padded_steps for r in r_round)
    assert wrk.compile_stats["worker_step"]["compiles"] <= 8


def test_residual_norm_and_compile_stats():
    eng = _port_engine(mesh_workers=2, combine_mode="tree",
                       combine_compress="int8")
    res = eng.run(2)
    assert all(r.residual_norm > 0 for r in res)
    stats = eng.compile_stats
    for label in ("worker_step", "merge_step", "encode_step",
                  "compressed_combine_step"):
        assert stats[label]["compiles"] == 1, label
    assert stats["combine_step"]["compiles"] == 0    # the compressed one runs
    assert stats["compressed_combine_step"]["hits"] == 1


# The reference's matrix (tests/test_properties.py) normalises its draws
# into arithmetic families; so does this one, and it maps bucket="worker"
# to "round" where the shard count is below 2 (a fused program has no
# per-worker S), which EngineConfig would rightly refuse.
def _normalise(depth, bucket, mesh, compress, hosts):
    if hosts >= 1:
        cfg = dict(mesh_workers=4, combine_mode="tree",
                   combine_compress=compress, hosts=hosts)
        ref = dict(cfg, hosts=1)
    elif compress != "none":
        cfg = dict(mesh_workers=mesh or 2, combine_mode="tree",
                   combine_compress=compress)
        ref = dict(cfg)
    else:
        cfg, ref = dict(mesh_workers=mesh), {}
    if cfg["mesh_workers"] < 2:
        bucket = "round"
    return dict(cfg, depth=depth, bucket_mode=bucket), dict(ref, depth=1)


@pytest.mark.parametrize("draw", [
    (0, "worker", 0, "none", 0), (2, "worker", 4, "none", 0),
    (0, "round", 2, "int8", 0), (1, "worker", 0, "topk", 0),
    (2, "worker", 0, "int8", 2), (0, "round", 4, "none", 4)])
def test_losses_bit_identical_within_arithmetic_family(draw):
    cfg, ref = _normalise(*draw)
    TConfig(pipeline_depth=cfg["depth"],
            **{k: v for k, v in cfg.items() if k != "depth"})
    assert _port_run(3, **cfg)[0] == _port_run(3, **ref)[0]


# -- the engine against the reference --------------------------------------------
def test_tree_losses_and_combine_bytes_track_the_reference():
    for cfg in (dict(mesh_workers=2), dict(mesh_workers=4,
                                           combine_mode="tree")):
        jl, jb = _ref_run(3, **cfg)
        tl, tb, _ = _port_run(3, ref_inputs=True, **cfg)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert tb == jb


@pytest.mark.parametrize("cfg", [
    dict(combine_compress="int8"), dict(combine_compress="topk"),
    dict(combine_compress="int8", hosts=2)])
def test_compressed_losses_and_combine_bytes_track_the_reference(cfg):
    cfg = dict(mesh_workers=2 if "hosts" not in cfg else 4,
               combine_mode="tree", **cfg)
    jl, jb = _ref_run(3, **cfg)
    tl, tb, _ = _port_run(3, ref_inputs=True, **cfg)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tb == jb


@pytest.mark.parametrize("cfg,match", [
    (dict(bucket_mode="worker"), "bucket_mode"),
    (dict(bucket_mode="sideways", mesh_workers=2), "bucket_mode"),
    (dict(combine_mode="tree"), "combine_mode"),
    (dict(combine_mode="ring", mesh_workers=2), "combine_mode"),
    (dict(mesh_workers=2, combine_compress="int8"), "combine_mode"),
    (dict(mesh_workers=2, combine_mode="tree", combine_compress="fp4"),
     "combine_compress"),
    (dict(mesh_workers=2, combine_mode="tree", combine_compress="topk",
          combine_topk_frac=0.0), "combine_topk_frac"),
    (dict(mesh_workers=0, hosts=1), "combine_mode='tree'"),
    (dict(mesh_workers=4, combine_mode="tree", hosts=3), "divide"),
    (dict(mesh_workers=12, combine_mode="tree", hosts=2), "power of two"),
    (dict(mesh_workers=4, combine_mode="tree", hosts=-1), "hosts"),
    (dict(mesh_workers=-1), "mesh_workers")])
def test_engine_config_refuses_what_the_reference_refuses(cfg, match):
    with pytest.raises(ValueError, match=match):
        JConfig(**cfg)
    with pytest.raises(ValueError, match=match):
        TConfig(**cfg)


@pytest.mark.parametrize("argv", [
    ["--combine-compress", "topk", "--combine-mode", "tree"],
    ["--bucket-mode", "worker"],
    ["--combine-mode", "tree", "--hosts", "2"]])
def test_entry_point_runs_the_mesh_options(argv, monkeypatch, capsys):
    """``main()`` on the CPU, one short round, with the SR model and
    dataset at this file's small widths (the card runs the published
    ones)."""
    monkeypatch.setattr(ttrain, "set_deterministic", lambda: None)
    monkeypatch.setattr(ttrain, "resolve_device",
                        lambda d: torch.device("cpu"))
    monkeypatch.setattr(ttrain, "make_federated_dataset",
                        lambda task, seed, **kw: tdataset(task, seed=seed,
                                                          **DS_KW))
    monkeypatch.setattr(ttrain, "make_task_model",
                        lambda task, seed, device: tmodel(task, seed,
                                                         device=device,
                                                         **SMALL))
    assert ttrain.main(["--task", "sr", "--workers", "4", "--mesh-workers",
                        "2", "--rounds", "1", "--cohort", "4",
                        "--steps-cap", "1", *argv]) == 0
    out = capsys.readouterr().out
    summary = __import__("json").loads(out[out.index("{"):])
    assert np.isfinite(summary["final_loss"])
    assert summary["mesh_workers"] == 2 and summary["padded_steps"] >= 0
    assert summary["combine_bytes_per_round"] > 0
