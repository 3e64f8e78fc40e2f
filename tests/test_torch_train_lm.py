"""The port's federated LM training (``--arch``) against the JAX reference
on the CPU: the ``"lm"`` token dataset, ``lm.loss_fn`` and its gradients,
the nested ↔ flat parameter mapping, one federated round step, engine
rounds, and the port's own bit-identity across pipeline depths and mesh
decompositions.

Inputs are made with numpy from a seed and given to both packages; the
reference's weights (``jax.random`` init) are carried across with
``lm_params_from_numpy``, and the port's engine is handed the reference's
dataset object (for whisper-base and internvl2-26b the reference's
``_FrontendDataset``, which adds the frame or patch stubs).  Reduced
configs (f32, 4 layers, d_model 64).
Tolerances, and why:

* dataset tables, offsets, leaf order, step counts and weights: exact;
* loss rtol 1e-5, gradients atol 1e-5 + rtol 1e-4: the two libraries sum
  GEMMs and reductions in other orders (measured ≤ 5 % of that bound);
* params after a round step or engine rounds: 1e-5 (rtol 1e-4 over three
  rounds, as the SR engine test);
* inside the port (depths 0/1/2, flat mesh vs fused, remat on/off):
  bitwise.
"""

import math
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _torch_parity import one_intra_op_thread  # noqa: E402,F401
from repro import configs as jconfigs  # noqa: E402
from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.core import FederatedEngine as JEngine  # noqa: E402
from repro.core import SyntheticTelemetry as JTelemetry  # noqa: E402
from repro.core import UniformSampler as JSampler  # noqa: E402
from repro.core import make_placement as jplacement  # noqa: E402
from repro.data import federated as jfed  # noqa: E402
from repro.distributed import WorkerPool as JPool  # noqa: E402
from repro.fl.round import make_round_step as jround_step  # noqa: E402
from repro.launch.train import _FrontendDataset as JFrontend  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import make_loss_fn as jmake_loss_fn  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.core import EngineConfig as TConfig  # noqa: E402
from repro_torch.core import FederatedEngine as TEngine  # noqa: E402
from repro_torch.core import SyntheticTelemetry as TTelemetry  # noqa: E402
from repro_torch.core import UniformSampler as TSampler  # noqa: E402
from repro_torch.core import make_placement as tplacement  # noqa: E402
from repro_torch.data import federated as tfed  # noqa: E402
from repro_torch.distributed import WorkerPool as TPool  # noqa: E402
from repro_torch.fl.round import make_round_step as tround_step  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.layout import (FlatLayout, flatten_tree,  # noqa: E402
                                        unflatten_tree)
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402

SEED = 1337
DENSE = ["qwen3-0.6b", "minitron-4b", "internlm2-1.8b", "command-r-plus-104b"]
# one arch per ported family: dense, ssm, MoE
FAMILIES = ["qwen3-0.6b", "mamba2-2.7b", "granite-moe-3b-a800m"]
MOE = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "jamba-v0.1-52b"]
# the modality-frontend archs: audio encoder-decoder, VLM
FRONTEND = ["whisper-base", "internvl2-26b"]
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _cfgs(name, **kw):
    return (replace(jconfigs.get_arch(name).reduced(), **kw),
            replace(tconfigs.get_arch(name).reduced(), **kw))


def _ref_params(jcfg, seed=0):
    p = jlm.init_params(jax.random.key(seed), jcfg)
    return p, tmodels.lm_params_from_numpy(jax.tree.map(np.asarray, p),
                                           device="cpu")


def _tokens(cfg, shape, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _stubs(cfg, lead, seed=4):
    """The modality stub arrays of ``cfg`` with leading dims ``lead`` (one
    batch's are ``lead + (b,)``), numpy f32; {} without a frontend."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "patch":
        tail = (cfg.frontend_len, cfg.resolved_frontend_dim)
        return {"patch_embed": rng.standard_normal(lead + tail,
                                                   dtype=np.float32)}
    if cfg.frontend == "audio":
        tail = (cfg.frontend_len, cfg.d_model)
        return {"frames": rng.standard_normal(lead + tail, dtype=np.float32)}
    return {}


def _paths(tree):
    """JAX's leaf order of a nested dict, each path joined with '/'."""
    return ["/".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _jflat(tree):
    return dict(zip(_paths(tree), jax.tree.leaves(tree)))


# -- the "lm" token dataset -----------------------------------------------------
@pytest.mark.parametrize("vocab,seq_len,batch", [(256, 16, 2), (32_000, 64, 8),
                                                 (151_936, 32, 4)])
def test_lm_dataset_tables_and_tokens_match_reference(vocab, seq_len, batch):
    kw = dict(seed=SEED, vocab_size=vocab, seq_len=seq_len, batch_size=batch,
              n_clients=512)
    j = jfed.make_federated_dataset("lm", **kw)
    t = tfed.make_federated_dataset("lm", **kw)
    assert vars(t.spec) == vars(j.spec)
    assert np.array_equal(t.sizes, j.sizes)
    cids = np.arange(0, 3 * 2 ** 31, 2 ** 24 + 7, dtype=np.int64)
    assert np.array_equal(t._token_offset(cids), j._token_offset(cids))
    assert [t.n_batches(c) for c in range(512)] == \
        [j.n_batches(c) for c in range(512)]
    cids, bis = np.array([0, 5, 5, 511]), np.array([0, 0, 3, 1])
    tb = t.gather_batches(cids, bis)["tokens"]
    jb = j.gather_batches(cids, bis)["tokens"]
    assert tb.shape == jb.shape == (4, batch, seq_len)
    assert tb.dtype == jb.dtype == np.int32
    # Both draw from the client's slice of the vocab: (tok - offset) mod V
    # below ceil(V / 4).
    for toks in (tb, jb):
        assert toks.min() >= 0 and toks.max() < vocab
        rel = (toks.astype(np.int64) - t._token_offset(cids)[:, None, None]) \
            % vocab
        assert rel.max() < -(-vocab // 4)
    # Content is a function of (client, batch) alone.
    assert np.array_equal(tb[1:3], t.gather_batches(cids[1:3], bis[1:3])
                          ["tokens"])
    assert np.array_equal(t.client_batch(5, 3)["tokens"], tb[2])
    assert not np.array_equal(tb[1], tb[2])
    short = t.gather_batches(cids[:1], bis[:1], batch_size=3, seq_len=5)
    assert short["tokens"].shape == (1, 3, 5)
    assert t.gather_batches(cids[:0], bis[:0])["tokens"].shape == \
        (0, batch, seq_len)


# -- loss_fn and its gradients ----------------------------------------------------
LOSS_CASES = ([(name, {}) for name in DENSE + ["mamba2-2.7b"] + MOE
               + FRONTEND]
              + [(name, kw) for name in FAMILIES
                 for kw in (dict(loss_chunk=5),
                            dict(vocab_size=200, loss_chunk=4))]
              + [(name, dict(vocab_size=200, loss_chunk=4))
                 for name in FRONTEND]
              + [("granite-moe-3b-a800m",
                  dict(moe_impl="scatter", moe_aux_weight=1.0)),
                 ("whisper-base", dict(remat=True))])


@pytest.mark.parametrize("name,kw", LOSS_CASES,
                         ids=[f"{n}-{'-'.join(map(str, k.values())) or 'one'}"
                              for n, k in LOSS_CASES])
def test_loss_and_grads_match_reference(name, kw):
    """``loss_chunk`` 0 (one chunk), 5 over 13 predicted positions (a
    ragged tail padded and masked), and vocab 200 (padded to 256: the pad
    columns masked out of the log-sum-exp).  The MoE archs add
    ``moe_aux_weight`` times their load-balance term (weight 1.0 on one
    case, so a dropped or mis-summed term could not pass).  whisper's
    gradients reach the encoder through cross-attention (with ``remat``
    too: each period, cross-attention included, recomputed in backward);
    internvl2's the patch projection through the text positions alone."""
    jcfg, tcfg = _cfgs(name, **kw)
    jp, tp = _ref_params(jcfg)
    batch = {"tokens": _tokens(jcfg, (2, 14)), **_stubs(jcfg, (2,))}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(lambda p: jlm.loss_fn(p, jbatch, jcfg))(jp)
    flat = flatten_tree(tp)
    for v in flat.values():
        v.requires_grad_()
    tl = tlm.loss_fn(tp, batch, tcfg, device="cpu")
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), **LOSS_TOL)
    jflat = _jflat(jg)
    assert sorted(jflat) == sorted(flat)
    for k, g in jflat.items():
        np.testing.assert_allclose(flat[k].grad.numpy(), np.asarray(g),
                                   err_msg=k, **GRAD_TOL)


def test_remat_changes_no_bit():
    """``cfg.remat`` recomputes each period in backward: the same loss and
    gradients, bit for bit."""
    out = []
    for remat in (False, True):
        _, cfg = _cfgs("qwen3-0.6b", remat=remat, loss_chunk=5)
        params = tlm.init_params(0, cfg, device="cpu")
        flat = flatten_tree(params)
        for v in flat.values():
            v.requires_grad_()
        loss = tlm.loss_fn(params, {"tokens": _tokens(cfg, (2, 14))}, cfg,
                           device="cpu")
        loss.backward()
        out.append((loss.detach(), {k: v.grad for k, v in flat.items()}))
    assert torch.equal(out[0][0], out[1][0])
    for k, g in out[0][1].items():
        assert torch.equal(g, out[1][1][k]), k


def test_loss_fn_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, cfg = _cfgs("qwen3-0.6b")
    params = tlm.init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.loss_fn(params, {"tokens": _tokens(cfg, (1, 4))}, cfg)


# -- nested <-> flat ------------------------------------------------------------
@pytest.mark.parametrize("name", FAMILIES + FRONTEND + ["synthetic"])
def test_flat_leaf_order_is_jax_order(name):
    if name == "synthetic":     # keys that are prefixes of one another
        tree = {"stack": {"p10": {"a": 1.0}, "p1": {"b": 2.0, "a_b": 3.0},
                          "p2": {"x": 0.0}},
                "lm_head": 4.0, "embed": 5.0, "final_norm": 6.0}
        ttree = jax.tree.map(lambda v: torch.full((2,), v), tree)
    else:
        jcfg, _ = _cfgs(name)
        tree, ttree = _ref_params(jcfg)
    flat = flatten_tree(ttree)
    assert FlatLayout(flat).names == sorted(flat) == _paths(tree)
    back = unflatten_tree(flat)
    again = flatten_tree(back)
    assert list(again) == list(flat)
    assert all(again[k] is v for k, v in flat.items())
    assert set(back) == set(tree) and set(back["stack"]) == set(tree["stack"])
    with pytest.raises(TypeError):
        back["stack"]["p1" if name == "synthetic" else "p0"] = {}


# -- one federated round step ------------------------------------------------------
@pytest.mark.parametrize("name", FAMILIES + FRONTEND)
def test_reduced_federated_train_step_matches_reference(name):
    """``tests/test_archs.py::test_reduced_federated_train_step`` (W=2, P=1,
    S=2, b=2, s=16) on the reference's params, held against its result."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _ref_params(jcfg)
    W, P, S, b, s = 2, 1, 2, 2, 16
    batch = {"tokens": _tokens(jcfg, (W, P, S, b, s), seed=1),
             **_stubs(jcfg, (W, P, S, b))}
    ones = np.ones((W, P, S), np.float32)
    boundary = np.zeros((W, P, S), np.float32)
    boundary[:, :, -1] = 1.0
    weight = boundary * 4.0
    jstep = jround_step(jmake_loss_fn(jcfg), jsgd(0.05, 0.9))
    jnew, jm = jstep(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                     jnp.asarray(ones), jnp.asarray(boundary),
                     jnp.asarray(weight))
    tstep = tround_step(tmodels.make_lane_loss_fn(tcfg), tsgd(0.05, 0.9))
    tnew, tm = tstep(flatten_tree(tp),
                     {k: torch.from_numpy(v) for k, v in batch.items()},
                     *(torch.from_numpy(a) for a in (ones, boundary, weight)))
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), **LOSS_TOL)
    assert float(tm.clients) == float(jm.clients) == W * P
    assert float(tm.total_weight) == float(jm.total_weight) == W * P * 4.0
    moved = 0.0
    for k, v in _jflat(jnew).items():
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-5, err_msg=k)
        moved += float(np.abs(np.asarray(v) - flatten_tree(tp)[k].numpy())
                       .sum())
    assert moved > 0


# -- the engine ---------------------------------------------------------------------
COHORT, WORKERS, LANES, STEPS_CAP, BATCH, SEQ = 4, 2, 2, 2, 2, 16


def _lm_dataset(vocab):
    return jfed.make_federated_dataset(
        "lm", seed=SEED, vocab_size=vocab, seq_len=SEQ, batch_size=BATCH,
        n_clients=64, size_mu=2.0, size_sigma=0.8)


def _dataset(cfg, wrap=ttrain._FrontendDataset):
    """The reference's ``"lm"`` dataset, with ``wrap``'s frontend stubs
    for an arch that has a frontend."""
    ds = _lm_dataset(cfg.vocab_size)
    return wrap(ds, cfg) if cfg.frontend else ds


def _ref_engine(ds, jcfg, jp):
    return JEngine(
        dataset=ds, loss_fn=jmake_loss_fn(jcfg), init_params=jp,
        optimizer=jsgd(0.05, momentum=0.9), placement=jplacement("lb"),
        sampler=JSampler(ds.n_clients, COHORT, seed=SEED),
        pool=JPool.homogeneous(WORKERS, type_name="a40", concurrency=LANES),
        telemetry=JTelemetry(seed=SEED),
        config=JConfig(steps_cap=STEPS_CAP, batch_size=BATCH, seq_len=SEQ,
                       seed=SEED, lanes_per_worker=LANES))


def _port_engine(ds, tcfg, tp, *, depth=1, workers=WORKERS, **config):
    return TEngine(
        dataset=ds, loss_fn=tmodels.make_lane_loss_fn(tcfg), init_params=tp,
        optimizer=tsgd(0.05, momentum=0.9), placement=tplacement("lb"),
        sampler=TSampler(ds.n_clients, COHORT, seed=SEED),
        pool=TPool.homogeneous(workers, type_name="a40", concurrency=LANES),
        telemetry=TTelemetry(seed=SEED),
        config=TConfig(steps_cap=STEPS_CAP, batch_size=BATCH, seq_len=SEQ,
                       lanes_per_worker=LANES, pipeline_depth=depth,
                       **config),
        device="cpu")


def test_three_rounds_track_the_reference_engine():
    """The reference engine and the port's on the same dataset object and
    weights: the same cohorts, placements and step counts, losses within
    rtol 1e-5, the final params leaf by leaf (the port hands back the
    nested tree it was given)."""
    jcfg, tcfg = _cfgs("qwen3-0.6b")
    jp, tp = _ref_params(jcfg)
    ds = _lm_dataset(jcfg.vocab_size)
    jeng = _ref_engine(ds, jcfg, jp)
    teng = _port_engine(ds, tcfg, tp)
    jres, tres = jeng.run(3), teng.run(3)
    for j, t in zip(jres, tres):
        for f in ("n_clients", "s_steps", "makespan", "idle_time"):
            assert getattr(t, f) == getattr(j, f), f
        np.testing.assert_allclose(t.loss, j.loss, **LOSS_TOL)
    assert set(teng.params) == set(jeng.params)
    tflat = flatten_tree(teng.params)
    for k, v in _jflat(jeng.params).items():
        np.testing.assert_allclose(tflat[k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", FRONTEND)
def test_frontend_rounds_track_the_reference_engine(name):
    """As :func:`test_three_rounds_track_the_reference_engine`, on the
    reference's ``_FrontendDataset`` (frames or patches beside the tokens)
    handed to both engines."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _ref_params(jcfg)
    ds = _dataset(jcfg, wrap=JFrontend)
    jres = _ref_engine(ds, jcfg, jp).run(3)
    teng = _port_engine(ds, tcfg, tp)
    tres = teng.run(3)
    for j, t in zip(jres, tres):
        for f in ("n_clients", "s_steps", "makespan", "idle_time"):
            assert getattr(t, f) == getattr(j, f), f
        np.testing.assert_allclose(t.loss, j.loss, **LOSS_TOL)
    assert sorted(teng.params) == sorted(jp)
    assert math.isfinite(tres[-1].loss)


@pytest.mark.parametrize("name", FRONTEND)
def test_frontend_dataset_matches_the_reference_wrapper(name):
    """The port's ``_FrontendDataset``: the reference's keys, shapes and
    dtype (f32), its tokens, and its empty-batch case; content a function
    of (client, batch) alone, standard normal (other values than the
    reference's ``jax.random`` by design)."""
    _, tcfg = _cfgs(name)
    cfg = replace(tcfg, frontend_len=64)
    j, t = _dataset(cfg, JFrontend), _dataset(cfg)
    cids, bis = np.array([0, 5, 5, 63]), np.array([0, 0, 3, 1])
    jb, tb = j.gather_batches(cids, bis), t.gather_batches(cids, bis)
    assert sorted(tb) == sorted(jb)
    for k in jb:
        assert tb[k].shape == jb[k].shape and tb[k].dtype == jb[k].dtype, k
    np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
    stub = "frames" if cfg.frontend == "audio" else "patch_embed"
    assert tb[stub].dtype == np.float32
    assert abs(float(tb[stub].mean())) < 0.05
    assert abs(float(tb[stub].std()) - 1.0) < 0.05
    np.testing.assert_array_equal(t.client_batch(5, 3)[stub], tb[stub][2])
    assert not np.array_equal(tb[stub][1], tb[stub][2])
    short = t.gather_batches(cids[:1], bis[:1], batch_size=3, seq_len=5)
    assert short[stub].shape == (1, 3) + tb[stub].shape[2:]
    empty, jempty = (d.gather_batches(cids[:0], bis[:0]) for d in (t, j))
    assert {k: v.shape for k, v in empty.items()} == \
        {k: v.shape for k, v in jempty.items()}
    assert t.n_clients == j.n_clients == 64


@pytest.mark.parametrize("name", FAMILIES + FRONTEND)
def test_losses_bit_identical_across_depths_and_mesh(name):
    """Depths 0/1/2 give the same losses, and the flat mesh at 2 shards
    (a program of 2 lanes per worker) the fused path's 4-lane result, bit
    for bit: each lane's loss runs on its own."""
    _, tcfg = _cfgs(name)
    tp = tlm.init_params(0, tcfg, device="cpu")
    ds = _dataset(tcfg)
    runs = {d: [r.loss for r in _port_engine(ds, tcfg, tp, depth=d).run(2)]
            for d in (0, 1, 2)}
    assert runs[0] == runs[1] == runs[2]
    assert all(np.isfinite(x) for x in runs[0])
    mesh = _port_engine(ds, tcfg, tp, mesh_workers=2)
    assert [r.loss for r in mesh.run(2)] == runs[1]


def test_build_engine_runs_lm_smoke_on_cpu():
    eng = ttrain.build_engine(arch="qwen3-0.6b", preset="smoke",
                              device="cpu", cohort=4, steps_cap=2)
    cfg, seq_len, batch = ttrain.lm_config("qwen3-0.6b", "smoke")
    assert cfg == tconfigs.get_arch("qwen3-0.6b").reduced()
    assert (eng.cfg.seq_len, eng.cfg.batch_size) == (seq_len, batch) == \
        (32, 4)
    assert sorted(eng.params) == ["embed", "final_norm", "stack"]
    assert tmodels.param_count(eng.params) == tmodels.param_count(
        tlm.init_params(0, cfg, device="cpu"))
    res = eng.run(1)
    assert np.isfinite(res[0].loss) and res[0].n_clients == 4
    assert eng.compile_stats["compiles"] == 1


@pytest.mark.parametrize("name", FRONTEND)
def test_build_engine_runs_frontend_smoke_on_cpu(name):
    """``arch=`` with a frontend: the dataset carries its stubs, the params
    the reference's extra leaves, and a round trains."""
    eng = ttrain.build_engine(arch=name, preset="smoke", device="cpu",
                              cohort=4, steps_cap=2, population=64)
    cfg, seq_len, batch = ttrain.lm_config(name, "smoke")
    extra = {"whisper-base": ["enc", "pos_embed"],
             "internvl2-26b": ["lm_head", "patch_proj"]}[name]
    assert sorted(eng.params) == sorted(["embed", "final_norm", "stack"]
                                        + extra)
    b = eng.dataset.client_batch(3, 1)
    stub = "frames" if cfg.frontend == "audio" else "patch_embed"
    assert b[stub].shape == (batch, cfg.frontend_len,
                             cfg.resolved_frontend_dim)
    res = eng.run(1)
    assert np.isfinite(res[0].loss) and res[0].n_clients == 4


@pytest.mark.parametrize("name", FRONTEND)
def test_cli_trains_a_frontend_arch_on_cpu(name, monkeypatch, capsys):
    """``--arch`` for the audio encoder-decoder and the VLM, through
    ``main``, with ``resolve_device`` patched to the CPU."""
    monkeypatch.setattr(ttrain, "set_deterministic", lambda: None)
    monkeypatch.setattr(ttrain, "resolve_device",
                        lambda d: torch.device("cpu"))
    assert ttrain.main(["--arch", name, "--preset", "smoke", "--rounds",
                        "1", "--cohort", "2", "--steps-cap", "1",
                        "--population", "32"]) == 0
    out = capsys.readouterr().out
    import json
    s = json.loads(out[out.index("{"):])
    assert s["rounds"] == 1 and np.isfinite(s["final_loss"])


@pytest.mark.parametrize("preset", list(ttrain.PRESETS))
def test_build_engine_trains_a_given_config_at_the_presets_sizes(preset):
    """``lm_cfg`` takes the config as given, and the preset's sequence
    length and batch size: the ``"lm"`` dataset and the engine both get
    them."""
    cfg = replace(tconfigs.get_arch("qwen3-0.6b").reduced(), vocab_size=300)
    eng = ttrain.build_engine(lm_cfg=cfg, preset=preset, device="cpu",
                              cohort=2, steps_cap=1, population=8)
    want = (ttrain.PRESETS[preset]["seq_len"],
            ttrain.PRESETS[preset]["batch_size"])
    assert (eng.cfg.seq_len, eng.cfg.batch_size) == want
    tokens = eng.dataset.client_batch(0, 0)["tokens"]
    assert tokens.shape == want[::-1] and int(tokens.max()) < 300
    assert tmodels.param_count(eng.params) == tmodels.param_count(
        tlm.init_params(1337, cfg, device="cpu"))


def test_lm_config_matches_the_reference_builder():
    """The fl100m preset's widths on top of ``reduced()``, as the
    reference's ``build_engine`` composes them
    (``repro/launch/train.py:161-173``): an MoE arch's experts take the
    preset's ``d_ff``; learned positions cover ``seq_len`` (whisper's
    128-row table of ``reduced()`` widens to 256)."""
    from repro.launch.train import PRESETS as JPRESETS
    assert ttrain.PRESETS == JPRESETS
    for name in FAMILIES + MOE + FRONTEND:
        cfg, seq_len, batch = ttrain.lm_config(name, "fl100m")
        p = dict(JPRESETS["fl100m"])
        assert (seq_len, batch) == (p.pop("seq_len"), p.pop("batch_size"))
        base = jconfigs.get_arch(name).reduced()
        if base.moe:
            p.setdefault("moe_d_ff", p.get("d_ff", 128))
        want = replace(base, **p)
        if want.learned_pos:
            want = replace(want, max_position=max(want.max_position,
                                                  seq_len))
        assert cfg.to_dict() == want.to_dict()
    assert ttrain.lm_config("whisper-base", "fl100m")[0].max_position == 256
    assert ttrain.lm_config("whisper-base", "smoke")[0].max_position == 128
    cfg, _, _ = ttrain.lm_config("granite-moe-3b-a800m", "fl100m")
    assert (cfg.n_experts, cfg.top_k, cfg.moe_d_ff) == (4, 2, 2048)
    shapes = flatten_tree(tlm.param_shapes(cfg))
    assert len(shapes) == 12
    assert sum(math.prod(x) for x in shapes.values()) == 269_998_848


def test_cli_trains_an_arch_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(ttrain, "set_deterministic", lambda: None)
    monkeypatch.setattr(ttrain, "resolve_device",
                        lambda d: torch.device("cpu"))
    assert ttrain.main(["--arch", "mamba2-2.7b", "--preset", "smoke",
                        "--rounds", "1", "--cohort", "2", "--steps-cap",
                        "1"]) == 0
    out = capsys.readouterr().out
    summary = out[out.index("{"):]
    import json
    s = json.loads(summary)
    assert s["rounds"] == 1 and np.isfinite(s["final_loss"])
    assert s["kernel_launches"]["fedavg_accum"] == 0     # CPU: plain K1


def test_lm_round_counts_no_kernel_launch_on_cpu():
    tops.reset_launch_counts()
    ttrain.build_engine(arch="qwen3-0.6b", device="cpu", cohort=2,
                        steps_cap=1).run(1)
    assert sum(tops.launch_counts().values()) == 0
