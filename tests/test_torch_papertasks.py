"""The port's IC, TG and MLM task models and its Adam against the JAX
reference, on the reference's weights and the same numpy batches.

Tolerances: the losses and gradients run the same f32 math through GEMMs
and reductions the two libraries order differently (rtol 1e-5, atol 1e-6;
TG's 2 x 11-step recurrence and MLM's softmax attention stay inside it);
lane-stacked losses against the same lanes one at a time differ only in
the GEMM batching (rtol 1e-6).  The MLM mask is integer arithmetic and
bitwise.  Adam does the reference's f32 elementwise ops in its order
(rtol 1e-6, for XLA's FMA contraction and pow).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from _torch_parity import one_intra_op_thread  # noqa: E402,F401
from repro.models import papertasks as jpt  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.models import papertasks as tpt  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
SMALL = {"ic": dict(width=32, n_blocks=2),
         "tg": dict(vocab=90, hidden=16),
         "mlm": dict(vocab=512, d_model=32, n_layers=2, d_ff=64)}
SEQ = {"tg": 12, "mlm": 16}


def _ref_params(task, seed=0, **kw):
    p, loss = jpt.make_task_model(task, jax.random.key(seed),
                                  **(kw or SMALL[task]))
    return {k: np.asarray(v) for k, v in p.items()}, loss


def _batch(task, seed, lanes=None, b=4):
    rng = np.random.default_rng(seed)
    lead = () if lanes is None else (lanes,)
    if task == "ic":
        return {"x": rng.standard_normal(lead + (b, 64), dtype=np.float32),
                "y": rng.integers(0, 596, lead + (b,)).astype(np.int32)}
    vocab = SMALL[task]["vocab"]
    return {"tokens": rng.integers(0, vocab, lead + (b, SEQ[task]))
            .astype(np.int32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}


@pytest.mark.parametrize("task", ["ic", "tg", "mlm"])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grads_match_reference(task, seed):
    p_np, jloss = _ref_params(task, seed)
    batch = _batch(task, seed)
    jl, jg = jax.value_and_grad(jloss)(
        jax.tree.map(jax.numpy.asarray, p_np),
        jax.tree.map(jax.numpy.asarray, batch))
    tp = {k: v.requires_grad_() for k, v in _t(p_np).items()}
    tl = tpt.TASK_MODELS[task].loss_fn(tp, _t(batch))
    assert tl.shape == ()
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    for k in p_np:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   **TOL, err_msg=k)


@pytest.mark.parametrize("task", ["ic", "tg", "mlm"])
def test_lane_stacked_loss_is_per_lane_loss(task):
    """Stacked params and batch give each lane the loss it has alone, and
    the backward of the lanes' sum gives each lane its own gradient."""
    lanes = [_ref_params(task, s)[0] for s in range(3)]
    batch = _t(_batch(task, 9, lanes=3))
    stacked = {k: torch.from_numpy(np.stack([p[k] for p in lanes]))
               .requires_grad_() for k in lanes[0]}
    loss_fn = tpt.TASK_MODELS[task].loss_fn
    got = loss_fn(stacked, batch)
    assert got.shape == (3,)
    got.sum().backward()
    for i, p in enumerate(lanes):
        one = {k: v.requires_grad_() for k, v in _t(p).items()}
        want = loss_fn(one, {k: v[i] for k, v in batch.items()})
        want.backward()
        np.testing.assert_allclose(float(got[i].detach()),
                                   float(want.detach()), rtol=1e-6)
        for k in p:
            np.testing.assert_allclose(stacked[k].grad[i].numpy(),
                                       one[k].grad.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_mlm_mask_matches_reference_over_the_whole_vocab():
    """Every token of a 32,000 vocab, most of which wrap the reference's
    int32 product (tokens >= 810): the masks are equal bit for bit."""
    toks = np.arange(32_000, dtype=np.int32).reshape(125, 256)
    want = np.asarray((jax.numpy.asarray(toks) * 2_654_435 % 100) < 15)
    got = tpt.mlm_mask(torch.from_numpy(toks)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.05 < got.mean() < 0.25
    # Widening before the product would give another mask.
    wide = (toks.astype(np.int64) * 2_654_435 % 100) < 15
    assert (wide != want).sum() > 1000


def test_mlm_loss_with_no_masked_token_is_zero():
    """m.sum() == 0 divides by 1, as the reference's max(m.sum(), 1)."""
    p_np, jloss = _ref_params("mlm", 0)
    masked = tpt.mlm_mask(torch.arange(512)).numpy()
    keep = np.flatnonzero(~masked)[:SEQ["mlm"]].astype(np.int32)
    batch = {"tokens": np.tile(keep, (2, 1))}
    got = tpt.TASK_MODELS["mlm"].loss_fn(_t(p_np), _t(batch))
    assert float(got) == 0.0 == float(jloss(
        jax.tree.map(jax.numpy.asarray, p_np),
        jax.tree.map(jax.numpy.asarray, batch)))


@pytest.mark.parametrize("task", ["ic", "sr", "tg", "mlm"])
def test_published_shapes_and_registry(task):
    kw = {"vocab": 512} if task in ("tg", "mlm") else {}
    params, _ = tpt.make_task_model(task, 1337, device="cpu", **kw)
    ref = jax.eval_shape(lambda k: jpt.make_task_model(task, k, **kw)[0],
                         jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    tm, jm = tpt.TASK_MODELS[task], jpt.TASK_MODELS[task]
    assert (tm.name, tm.target_bytes, tm.kind) == \
        (jm.name, jm.target_bytes, jm.kind)


@pytest.mark.parametrize("task,n", [("ic", 300_032), ("tg", 9_244_672),
                                    ("mlm", 11_339_776)])
def test_default_vocab_and_parameter_count(task, n):
    """TG and MLM default to the reference's 32,000-token vocab; the counts
    are the reference's (read off its shapes)."""
    ref = jax.eval_shape(lambda k: jpt.make_task_model(task, k)[0],
                         jax.random.key(0))
    assert sum(math.prod(v.shape) for v in ref.values()) == n
    gen = torch.Generator().manual_seed(0)
    kw = {"vocab": 32_000} if task != "ic" else {}
    shapes = {k: tuple(v.shape)
              for k, v in tpt.TASK_MODELS[task].init(gen, **kw).items()}
    assert shapes == {k: tuple(v.shape) for k, v in ref.items()}


def test_numpy_round_trip_keeps_mlm_stacked_leaves():
    p_np, _ = _ref_params("mlm", 3)
    back = tpt.params_to_numpy(tpt.params_from_numpy(p_np, device="cpu"))
    assert back["wq"].shape == (2, 32, 32)
    for k in p_np:
        np.testing.assert_array_equal(back[k], p_np[k])


# -- Adam ---------------------------------------------------------------------
ADAM_TOL = dict(rtol=1e-6, atol=1e-9)
ADAM_SHAPES = {"stem": (16, 8), "head": (8, 3), "bias": (8,)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in ADAM_SHAPES.items()}


@pytest.mark.parametrize("name,kw", [("adam", dict(lr=4e-5)),
                                     ("adam", dict(lr=1e-2, weight_decay=0.1)),
                                     ("adamw", dict(lr=1e-2)),
                                     ("adamw", dict(lr=3e-3, b1=0.8,
                                                    weight_decay=0.05))])
def test_adam_tracks_reference_over_steps(name, kw):
    jo, to = jopt.make_optimizer(name, **kw), topt.make_optimizer(name, **kw)
    jp = jax.tree.map(jax.numpy.asarray, _tree(0))
    tp = _t(_tree(0))
    js, ts = jo.init(jp), to.init(tp)
    assert ts.step.shape == () and ts.step.dtype == torch.int32
    for step in range(6):
        g = _tree(100 + step, scale=10.0 ** (step % 3 - 1))
        ju, js = jo.update(jax.tree.map(jax.numpy.asarray, g), js, jp)
        tu, ts = to.update(_t(g), ts, tp)
        for k in ADAM_SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       **ADAM_TOL)
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
    assert int(ts.step) == int(js.step) == 6
    for k in ADAM_SHAPES:
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]),
                                   **ADAM_TOL)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]),
                                   **ADAM_TOL)
        assert ts.mu[k].dtype == ts.nu[k].dtype == torch.float32


def test_adam_per_lane_step_with_a_masked_lane():
    """The round step's use: one model's state stacked over 3 lanes, then
    3 updates where lane 1 is masked at step 2 (it keeps its old state).
    ``step`` is ``[L]`` and each lane matches the reference run on that
    lane alone with that lane's own number of updates."""
    from repro_torch.fl.round import _stack_state, _tree_select
    opt = topt.adam(1e-2, weight_decay=1e-3)
    jo = jopt.adam(1e-2, weight_decay=1e-3)
    flat0 = np.concatenate([v.ravel() for v in _tree(1).values()])
    theta = torch.from_numpy(np.stack([flat0] * 3))
    state = _stack_state(opt.init({"flat": torch.from_numpy(flat0)}), 3)
    assert state.step.shape == (3,)
    masks = [[1, 1, 1], [1, 0, 1], [1, 1, 1]]
    grads = [np.random.default_rng(50 + s).standard_normal(
        theta.shape).astype(np.float32) for s in range(3)]
    for g, m in zip(grads, masks):
        m = torch.tensor(m, dtype=torch.float32)
        upd, new = opt.update({"flat": torch.from_numpy(g)}, state,
                              {"flat": theta})
        theta = theta + upd["flat"] * m[:, None]
        state = _tree_select(m > 0, new, state)
    assert state.step.tolist() == [3, 2, 3]
    for lane in range(3):
        jp = {"flat": jax.numpy.asarray(flat0)}
        js = jo.init(jp)
        for g, m in zip(grads, masks):
            if m[lane]:
                ju, js = jo.update({"flat": jax.numpy.asarray(g[lane])}, js,
                                   jp)
                jp = jopt.apply_updates(jp, ju)
        assert int(js.step) == int(state.step[lane])
        np.testing.assert_allclose(theta[lane].numpy(),
                                   np.asarray(jp["flat"]), **ADAM_TOL)
        np.testing.assert_allclose(state.mu["flat"][lane].numpy(),
                                   np.asarray(js.mu["flat"]), **ADAM_TOL)


def test_make_optimizer_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("lamb", lr=1.0)


# -- the tasks through the engine and the CLI ----------------------------------
def _opt(pkg, task):
    """The reference's per-task client optimizer
    (``repro/launch/train.py:190-192``)."""
    if task == "mlm":
        return pkg.adam(4e-5)
    return pkg.sgd(0.8 if task == "tg" else 0.05, momentum=0.9,
                   weight_decay=5e-4)


def _task_engine(task, port: bool, depth=1):
    """A reduced task engine (cohort 4 over 2 workers x 2 lanes,
    ``steps_cap`` 2, LB) on the reference's dataset and weights."""
    from repro.core import EngineConfig as JConfig
    from repro.core import FederatedEngine as JEngine
    from repro.core import SyntheticTelemetry as JTel
    from repro.core import UniformSampler as JSampler
    from repro.core import make_placement as jplace
    from repro.data import make_federated_dataset
    from repro.distributed import WorkerPool as JPool
    from repro_torch import core as tcore
    from repro_torch.distributed import WorkerPool as TPool
    extra = ({"vocab_size": SMALL[task]["vocab"], "seq_len": SEQ[task]}
             if task != "ic" else {})
    ds = make_federated_dataset(task, n_clients=64, batch_size=4,
                                size_mu=2.5, size_sigma=0.8, **extra)
    p_np, jloss = _ref_params(task)
    cfg = dict(steps_cap=2, batch_size=4, lanes_per_worker=2,
               pipeline_depth=depth, seq_len=SEQ.get(task))
    if port:
        return tcore.FederatedEngine(
            dataset=ds, loss_fn=tpt.TASK_MODELS[task].loss_fn,
            init_params=_t(p_np), optimizer=_opt(topt, task),
            placement=tcore.make_placement("lb"),
            sampler=tcore.UniformSampler(64, 4),
            pool=TPool.homogeneous(2, type_name="a40", concurrency=2),
            telemetry=tcore.SyntheticTelemetry(),
            config=tcore.EngineConfig(**cfg), device="cpu")
    return JEngine(
        dataset=ds, loss_fn=jloss,
        init_params=jax.tree.map(jax.numpy.asarray, p_np),
        optimizer=_opt(jopt, task), placement=jplace("lb"),
        sampler=JSampler(64, 4),
        pool=JPool.homogeneous(2, type_name="a40", concurrency=2),
        telemetry=JTel(), config=JConfig(**cfg))


@pytest.mark.parametrize("task", ["ic", "tg", "mlm"])
def test_task_engines_track_the_reference(task):
    """Two rounds of each task's engine (MLM through Adam) on both
    packages: the same cohorts, losses within rtol 1e-5 and the final
    params within 1e-4 + 1e-6; the port's rounds bitwise at depth 0."""
    jeng, teng = _task_engine(task, False), _task_engine(task, True)
    jres, tres = jeng.run(2), teng.run(2)
    for j, t in zip(jres, tres):
        assert (t.n_clients, t.makespan, t.s_steps) == \
            (j.n_clients, j.makespan, j.s_steps)
        np.testing.assert_allclose(t.loss, j.loss, **TOL)
    for k, v in teng.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jeng.params[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    sync = [r.loss for r in _task_engine(task, True, depth=0).run(2)]
    assert sync == [r.loss for r in tres]


@pytest.mark.parametrize("task", ["ic", "tg", "mlm"])
def test_cli_trains_each_task_with_its_optimizer(task, monkeypatch, capsys):
    """``--task ic|tg|mlm`` through ``main`` on the CPU (the model and the
    token vocab cut to the reduced widths): one round trains, and ``build_engine`` picks the
    reference's optimizer — Adam at 4e-5 for MLM (its first update of a
    unit gradient is -lr), SGD at 0.8 for TG and 0.05 for IC."""
    from repro_torch.launch import train as ttrain

    from repro_torch.data import make_federated_dataset

    def small(task_, seed, *, device):
        return tpt.make_task_model(task_, seed, device=device,
                                   **SMALL[task_])

    def small_vocab(task_, **kw):
        if task_ != "ic":
            kw.update(vocab_size=SMALL[task_]["vocab"], seq_len=SEQ[task_])
        return make_federated_dataset(task_, **kw)

    monkeypatch.setattr(ttrain, "make_task_model", small)
    monkeypatch.setattr(ttrain, "make_federated_dataset", small_vocab)
    monkeypatch.setattr(ttrain, "set_deterministic", lambda: None)
    monkeypatch.setattr(ttrain, "resolve_device",
                        lambda d: torch.device("cpu"))
    assert ttrain.main(["--task", task, "--rounds", "1", "--cohort", "2",
                        "--workers", "1", "--steps-cap", "1",
                        "--population", "64"]) == 0
    out = capsys.readouterr().out
    assert np.isfinite(__import__("json").loads(
        out[out.index("{"):])["final_loss"])
    opt = ttrain.build_engine(task=task, device="cpu", population=64).optimizer
    one = {"flat": torch.ones(3)}
    upd, _ = opt.update(one, opt.init({"flat": torch.zeros(3)}),
                        {"flat": torch.zeros(3)})
    # Adam's first step is -lr * g/|g| up to f32 roundings of its bias
    # corrections (~1e-5 relative); the three rates differ ~16x or more.
    want = {"mlm": -4e-5, "tg": -0.8, "ic": -0.05}[task]
    np.testing.assert_allclose(upd["flat"].numpy(), want, rtol=1e-4)
