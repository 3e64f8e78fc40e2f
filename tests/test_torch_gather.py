"""The port's gather path — FedMedian, the gather round step, and the
engine dispatch for a non-associative strategy — against the JAX
reference.

Tolerances: the median sorts and takes ``(lo + hi) * 0.5`` exactly as
``jnp.median`` does, so it is held bitwise; the gather step trains
through GEMMs whose sums the two libraries order differently (rtol 1e-5,
atol 1e-6), and so do the engines' losses over 3 rounds; inside the port
the losses are bitwise across pipeline depths.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import _torch_parity as par  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401
from repro.core import aggregation as jagg  # noqa: E402
from repro.core.placement import Assignment, ClientInfo  # noqa: E402
from repro.data.batching import build_round_arrays  # noqa: E402
from repro.distributed import WorkerPool as JPool  # noqa: E402
from repro.fl import round as jround  # noqa: E402
from repro.fl import strategy as jstrat  # noqa: E402
from repro.models.papertasks import make_task_model as jmodel  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.fl import round as tround  # noqa: E402
from repro_torch.fl import strategy as tstrat  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.papertasks import TASK_MODELS  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 2, 4)}


def _trees(n, seed=0, ties=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = {k: rng.standard_normal(s, dtype=np.float32)
             for k, s in SHAPES.items()}
        if ties and i % 2:
            t = {k: v.copy() for k, v in out[-1].items()}   # equal models
        out.append(t)
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("ties", [False, True])
def test_fedmedian_is_bitwise_jnp_median(n, ties):
    trees = _trees(n, seed=n, ties=ties)
    want = jagg.fedmedian([jax.tree.map(jnp.asarray, t) for t in trees])
    got = tagg.fedmedian([par.to_torch(t) for t in trees])
    for k in SHAPES:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("bad", ["nan", "inf", "-inf", "inf_and_nan"])
def test_fedmedian_matches_jnp_median_on_non_finite_models(n, bad):
    """One client's model holds a NaN, +inf or -inf (a diverged client):
    NaN wherever ``jnp.median`` gives NaN, bitwise elsewhere — finite
    columns keep their bits, the infinities sort as the reference's."""
    trees = _trees(n, seed=20 + n)
    sick = trees[n // 2]
    if bad == "inf_and_nan":
        sick["a"][0, :2] = np.inf
        sick["b"][3] = np.nan
        trees[0]["a"][0, 0] = -np.inf
    else:
        sick["a"][1, 1] = sick["b"][0] = sick["c"][1, 0, 3] = float(bad)
    want = jagg.fedmedian([jax.tree.map(jnp.asarray, t) for t in trees])
    got = tagg.fedmedian([par.to_torch(t) for t in trees])
    for k in SHAPES:
        w = np.asarray(want[k])
        np.testing.assert_array_equal(np.isnan(got[k].numpy()), np.isnan(w))
        np.testing.assert_array_equal(got[k].numpy(), w)
    if bad == "nan":
        assert np.isnan(np.asarray(want["b"])[0])


@pytest.mark.parametrize("n", [3, 4])
def test_strategy_reduces_match_the_reference(n):
    """FedMedian.reduce bitwise (the weights ignored); FedAvg.reduce with
    and without a server learning rate within f32 rounding."""
    trees = _trees(n, seed=10 + n)
    stacked = {k: np.stack([t[k] for t in trees]) for k in SHAPES}
    glob = _trees(1, seed=99)[0]
    w = np.arange(1, n + 1, dtype=np.float32)
    jargs = (jax.tree.map(jnp.asarray, stacked), jnp.asarray(w),
             jax.tree.map(jnp.asarray, glob))
    targs = (par.to_torch(stacked), torch.from_numpy(w), par.to_torch(glob))
    got = tstrat.FedMedian().reduce(*targs)
    want = jstrat.FedMedian().reduce(*jargs)
    for k in SHAPES:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for lr in (1.0, 0.5):
        got = tstrat.FedAvg(server_lr=lr).reduce(*targs)
        want = jstrat.FedAvg(server_lr=lr).reduce(*jargs)
        for k in SHAPES:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)


def test_median_of_a_flat_buffer_is_the_median_of_its_leaves():
    """The engine reduces the round's ``[W·P, N]`` models as one leaf."""
    trees = [par.to_torch(t) for t in _trees(4, seed=3)]
    per_leaf = tagg.fedmedian(trees)
    flat = torch.stack([torch.cat([t[k].reshape(-1) for k in sorted(t)])
                        for t in trees])
    whole = tagg.median_leading(flat)
    assert torch.equal(whole, torch.cat([per_leaf[k].reshape(-1)
                                         for k in sorted(per_leaf)]))


def test_strategy_from_name():
    assert isinstance(tstrat.strategy_from_name("FedMedian"),
                      tstrat.FedMedian)
    assert tstrat.strategy_from_name("fedavg", server_lr=0.5).server_lr == 0.5
    assert not tstrat.FedMedian().associative
    with pytest.raises(ValueError, match="unknown strategy"):
        tstrat.strategy_from_name("krum")


def _gather_arrays():
    """2 workers x 2 lanes: worker 0 holds 3 clients (one lane trains two
    in sequence), worker 1 holds 1 (its second lane is idle)."""
    ds = par.system_dataset()
    workers = JPool.homogeneous(2, type_name="a40", concurrency=2).snapshot()
    info = [ClientInfo(cid=c, n_batches=ds.n_batches(c),
                       n_samples=ds.n_samples(c)) for c in (0, 1, 2, 3)]
    asg = Assignment(per_worker={workers[0].wid: info[:3],
                                 workers[1].wid: info[3:]})
    a = build_round_arrays(ds, asg, workers, lanes_per_worker=2,
                           steps_cap=4, batch_size=4)
    per_lane = a.boundary.sum(-1).reshape(-1)
    assert sorted(per_lane.tolist()) == [0.0, 1.0, 1.0, 2.0]
    return a


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_gather_step_matches_the_reference(opt):
    """Two clients on one lane train in sequence on one model (the
    reference does not reset a lane at a client boundary), and the idle
    lane returns the global model bit for bit."""
    a = _gather_arrays()
    args = [a.batches, a.step_mask, a.boundary, a.weight]
    p_np = par.system_params()
    kw = dict(lr=0.1, momentum=0.9) if opt == "sgd" else dict(lr=1e-3)
    _, jloss = jmodel("sr", jax.random.key(0), **par.SYS_MODEL)
    jstep = jround.make_gather_round_step(jloss,
                                          jopt.make_optimizer(opt, **kw))
    jth, jw, jm = jstep(jax.tree.map(jnp.asarray, p_np),
                        *jax.tree.map(jnp.asarray, args))
    tstep = tround.make_gather_round_step(TASK_MODELS["sr"].loss_fn,
                                          topt.make_optimizer(opt, **kw))
    params = par.to_torch(p_np)
    tth, tw, tm = tstep(params, par.to_torch(args[0]),
                        *[torch.from_numpy(x) for x in args[1:]])
    from repro_torch.kernels.layout import FlatLayout
    layout = FlatLayout.of(params)
    assert list(tth) == ["flat"] and tth["flat"].shape == (4, layout.n)
    got = layout.views(tth)
    for k in p_np:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jth[k]), **TOL)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    idle = int(np.flatnonzero(a.boundary.sum(-1).reshape(-1) == 0)[0])
    assert torch.equal(tth["flat"][idle], layout.flatten(params))
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), **TOL)
    for f in ("steps", "clients", "total_weight"):
        assert float(getattr(tm, f)) == float(getattr(jm, f))


def test_fedmedian_engine_tracks_the_reference():
    """``tests/test_system.py:59`` on both packages: 3 rounds through the
    gather path, the same cohorts and placements, losses within rtol 1e-5
    and the robust aggregate still trains."""
    jres = par.system_engine(False, strategy="fedmedian").run(3)
    teng = par.system_engine(True, strategy="fedmedian")
    tres = teng.run(3)
    for j, t in zip(jres, tres):
        assert (t.n_clients, t.makespan, t.s_steps) == \
            (j.n_clients, j.makespan, j.s_steps)
        np.testing.assert_allclose(t.loss, j.loss, **TOL)
    assert tres[-1].loss < tres[0].loss * 1.1
    stats = teng.compile_stats
    assert stats["compiles"] == 1 and "gather_step" not in stats


def test_fedmedian_losses_bitwise_across_depths():
    runs = {d: [(r.loss, r.makespan) for r in
                par.system_engine(True, strategy="fedmedian",
                                  depth=d).run(4)]
            for d in (0, 1, 2)}
    assert runs[0] == runs[1] == runs[2]
    assert all(np.isfinite(loss) for loss, _ in runs[0])


def test_gather_path_refuses_the_mesh():
    """As the reference (``repro/core/engine.py:524-529``)."""
    with pytest.raises(ValueError, match="associative strategy"):
        par.system_engine(True, strategy="fedmedian", workers=4,
                          mesh_workers=2)


def test_cli_fedmedian_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(ttrain, "set_deterministic", lambda: None)
    monkeypatch.setattr(ttrain, "resolve_device",
                        lambda d: torch.device("cpu"))
    assert ttrain.main(["--task", "sr", "--strategy", "fedmedian",
                        "--rounds", "1", "--cohort", "3", "--workers", "1",
                        "--steps-cap", "1", "--population", "64"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert summary["rounds"] == 1 and np.isfinite(summary["final_loss"])
    assert summary["kernel_launches"]["fedavg_accum"] == 0
