"""Federated rounds at the published mixed dtypes (bf16 matrices beside f32
norm scales and Mamba rows) in the port, held against the JAX reference on
the CPU.

The port lays a mixed tree out per dtype group (``FlatLayout.groups``): one
flat buffer per dtype, each kept in its own dtype, and K1 folds each group
once a lane-loop step.  Inputs are made with numpy from a seed and handed
to both packages; the reference's bf16 weights cross with
``lm_params_from_numpy`` (their 16 bits, exactly).

Tolerances, and why:

* a single-dtype layout, its buffers and every f32 round: exactly as before
  (the f32 tests of the other files hold them bitwise);
* one round of a reduced config in bf16, loss rtol 1e-3, params atol
  ``BF16_PARAM_ATOL`` = 2^-7 (one bf16 ulp at |w| < 2), and the round's
  update (new minus initial params) within ``BF16_UPDATE_RTOL`` = 0.1 of
  the reference's in relative norm over each dtype group and within
  ``BF16_LEAF_UPDATE_RTOL`` = 0.3 over each leaf: both packages round
  each bf16 operation, but XLA may keep a fused chain's intermediates in
  f32 (its excess-precision rule) where PyTorch rounds every op, and the
  GEMMs sum in other orders.  Measured on these inputs: params within
  9.8e-4 (qwen3) and 1.95e-3 (mamba2), losses within 1.0e-5 and 5.9e-5
  relative, group updates within 0.043 and 0.049 (bf16) and 0.018 and
  0.028 (f32), leaf updates within 0.165 and 0.167, the same for both fold
  routes.  Unchanged params are off by 1, a round that folded one of its
  two workers by 0.99 in its bf16 group (held to ``_CONTROL_MIN`` = 0.5 or
  more by test_update_measure_rejects_wrong_rounds);
* the fold and the lanes' weighted mean alone, on bf16 lane buffers:
  bitwise the reference's, route for route — ``"plain"`` rounds each
  bf16 operation as ``_accum_leaf_xla`` does, ``"kernel"`` computes in f32
  and rounds once as the Pallas kernel does — and the two routes differ
  (a round's training noise hides that difference).
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _torch_parity import one_intra_op_thread  # noqa: E402,F401
from repro import configs as jconfigs  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.fl.round import make_round_step as jround_step  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import make_loss_fn as jmake_loss_fn  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.fl.round import make_round_step as tround_step  # noqa: E402
from repro_torch.kernels.layout import FlatLayout, flatten_tree  # noqa: E402
from repro_torch.launch.train import build_engine  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402

BF16_LOSS_RTOL = 1e-3
BF16_PARAM_ATOL = 2.0 ** -7
BF16_UPDATE_RTOL = 0.1
BF16_LEAF_UPDATE_RTOL = 0.3
# What one round measured on this file's inputs (max |Δ| over all params,
# |Δloss| / loss), recorded beside the tolerances it is held to.
_MEASURED = {}


def _cfgs(name):
    return (replace(jconfigs.get_arch(name).reduced(), dtype="bfloat16"),
            replace(tconfigs.get_arch(name).reduced(), dtype="bfloat16"))


def _paths(tree):
    return ["/".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _ref_params(jcfg):
    p = jlm.init_params(jax.random.key(0), jcfg)
    return p, flatten_tree(tmodels.lm_params_from_numpy(
        jax.tree.map(np.asarray, p), device="cpu"))


def _round_inputs(cfg, W=2, P=1, S=2, b=2, s=16):
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (W, P, S, b, s)).astype(np.int32)
    ones = np.ones((W, P, S), np.float32)
    boundary = np.zeros((W, P, S), np.float32)
    boundary[:, :, -1] = 1.0
    return {"tokens": tokens}, ones, boundary, boundary * 4.0


def _as_f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- the layout ---------------------------------------------------------------------
def test_single_dtype_layout_is_unchanged():
    gen = torch.Generator().manual_seed(0)
    tree = {k: torch.randn(s, generator=gen)
            for k, s in (("b", (3, 4)), ("a", (5,)), ("c", ()))}
    lay = FlatLayout(tree)
    assert not lay.mixed and lay.groups == (lay,) and lay.keys == ("flat",)
    assert lay.names == ["a", "b", "c"] and lay.offsets == [0, 5, 17, 18]
    flat = lay.flatten(tree)
    assert torch.equal(flat, torch.cat([tree[k].reshape(-1)
                                        for k in lay.names]))
    groups = lay.flatten_groups(tree)
    assert list(groups) == ["flat"] and torch.equal(groups["flat"], flat)
    views = lay.views(flat)
    assert views.flat is flat and views.flats == {"flat": flat}
    assert lay.views({"flat": flat}).flat is flat
    assert lay.flatten(views) is flat and lay.flatten_groups(views)["flat"] \
        is flat
    # A layout's dtype is part of it.
    half = FlatLayout({k: v.to(torch.bfloat16) for k, v in tree.items()})
    assert half != lay and hash(half) != hash(lay)
    assert half == FlatLayout({k: v.to(torch.bfloat16)
                               for k, v in tree.items()})


@pytest.mark.parametrize("name", ["qwen3-0.6b", "mamba2-2.7b"])
def test_mixed_layout_groups_by_dtype_in_jax_order(name):
    jcfg, _ = _cfgs(name)
    jp, tp = _ref_params(jcfg)
    lay = FlatLayout(tp)
    want = {d: [k for k, v in zip(_paths(jp), jax.tree.leaves(jp))
                if str(v.dtype) == d] for d in ("bfloat16", "float32")}
    assert lay.mixed and set(lay.keys) == set(want)
    for key, group in zip(lay.keys, lay.groups):
        assert group.names == want[key] and not group.mixed
        assert {str(d).removeprefix("torch.") for d in group.dtypes} == {key}
    flats = lay.flatten_groups(tp)
    tree = lay.views(flats)
    assert list(tree) == lay.names == sorted(tp)
    for k, v in tp.items():
        assert torch.equal(tree[k], v) and tree[k].dtype == v.dtype
        key = str(v.dtype).removeprefix("torch.")
        assert tree[k].untyped_storage().data_ptr() == \
            flats[key].untyped_storage().data_ptr()
    assert lay.flatten_groups(tree) == tree.flats
    for refuse in (lambda: lay.flatten(tp), lambda: tree.flat,
                   lambda: lay.offsets_on("cpu"), lay.scalars):
        with pytest.raises(ValueError, match="single-dtype layout"):
            refuse()


# -- the optimizers -------------------------------------------------------------------
def test_optimizer_state_dtypes_per_group():
    """SGD momentum is ``zeros_like`` the params (bf16 stays bf16), Adam's
    moments are f32, as in ``repro/optim/optimizers.py``."""
    flats = {"bfloat16": torch.zeros(6, dtype=torch.bfloat16),
             "float32": torch.zeros(2)}
    mom = tsgd(0.1, momentum=0.9).init(flats).momentum
    assert {k: v.dtype for k, v in mom.items()} == {
        "bfloat16": torch.bfloat16, "float32": torch.float32}
    st = tadam(1e-3).init(flats)
    assert {v.dtype for v in (*st.mu.values(), *st.nu.values())} == {
        torch.float32}
    grads = {k: torch.ones_like(v) for k, v in flats.items()}
    upd, _ = tadam(1e-3).update(grads, st, flats)
    assert upd["bfloat16"].dtype == torch.bfloat16


# -- one round against the reference -------------------------------------------------
def _ref_round(name, jimpl, weight_scale=(1.0, 1.0)):
    """The reference's round on this file's inputs: ``({path: f32 numpy},
    loss)``; ``weight_scale`` multiplies each worker's client weights."""
    jcfg, _ = _cfgs(name)
    jp, _ = _ref_params(jcfg)
    batch, ones, boundary, weight = _round_inputs(jcfg)
    weight = weight * np.asarray(weight_scale, np.float32)[:, None, None]
    jstep = jround_step(jmake_loss_fn(jcfg), jsgd(0.05, 0.9), agg_impl=jimpl)
    jnew, jm = jstep(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                     jnp.asarray(ones), jnp.asarray(boundary),
                     jnp.asarray(weight))
    return ({k: _as_f32(v) for k, v in zip(_paths(jnew),
                                           jax.tree.leaves(jnew))},
            float(jm.loss), float(jm.total_weight))


def _update_rel(new, want, init):
    """``||Δnew − Δwant|| / ||Δwant||``, Δ the update from ``init``
    (``{path: f32 numpy}`` each): ``({dtype group: r}, {leaf: r})``."""
    num, den, leaf = {}, {}, {}
    for k, w in want.items():
        key = str(init[k].dtype)
        d2 = float(np.square(new[k] - w).sum())
        w2 = float(np.square(w - init[k].float().numpy()).sum())
        num[key] = num.get(key, 0.0) + d2
        den[key] = den.get(key, 0.0) + w2
        leaf[k] = (d2 / w2) ** 0.5 if w2 else float(d2 > 0)
    return {k: (num[k] / den[k]) ** 0.5 for k in den}, leaf


def _within(rel) -> bool:
    groups, leaves = rel
    return max(groups.values()) <= BF16_UPDATE_RTOL and \
        max(leaves.values()) <= BF16_LEAF_UPDATE_RTOL


@pytest.mark.parametrize("name", ["qwen3-0.6b", "mamba2-2.7b"])
@pytest.mark.parametrize("impls", [("plain", "xla"), ("kernel", "pallas")])
def test_mixed_round_matches_reference(name, impls):
    """One round (W=2, P=1, S=2, b=2, s=16) of a reduced config in bf16:
    the port's ``"plain"`` fold against the reference's ``"xla"`` (bf16
    arithmetic on a bf16 leaf), its ``"kernel"`` route (the plain version on
    the CPU: f32 math, cast back) against ``"pallas"`` in interpret mode."""
    timpl, jimpl = impls
    jcfg, tcfg = _cfgs(name)
    _, tp = _ref_params(jcfg)
    batch, ones, boundary, weight = _round_inputs(jcfg)
    want, jloss, jweight = _ref_round(name, jimpl)
    tstep = tround_step(tmodels.make_lane_loss_fn(tcfg), tsgd(0.05, 0.9),
                        agg_impl=timpl)
    tnew, tm = tstep(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                     *(torch.from_numpy(a) for a in (ones, boundary, weight)))
    loss_rel = abs(float(tm.loss) - jloss) / abs(jloss)
    assert loss_rel <= BF16_LOSS_RTOL
    assert float(tm.total_weight) == jweight == 8.0
    got = {}
    for k, v in want.items():
        assert tnew[k].dtype == tp[k].dtype, k
        got[k] = tnew[k].float().numpy()
    worst = max(float(np.abs(got[k] - v).max()) for k, v in want.items())
    rel = _update_rel(got, want, tp)
    _MEASURED[(name, timpl)] = (worst, loss_rel, rel[0],
                                max(rel[1].values()))
    assert worst <= BF16_PARAM_ATOL, (worst, _MEASURED)
    assert _within(rel), _MEASURED[(name, timpl)]


# A wrong round is off by at least this much in the update measure.
_CONTROL_MIN = 0.5


@pytest.mark.parametrize("name", ["qwen3-0.6b", "mamba2-2.7b"])
def test_update_measure_rejects_wrong_rounds(name):
    """The update measure tells a wrong round from a right one: params left
    as they were, and a round that folded only one of its two workers (the
    other's weight zeroed), both fail ``_within`` by ``_CONTROL_MIN`` or
    more; the reference's largest update is several times the params'
    absolute tolerance."""
    jcfg, _ = _cfgs(name)
    _, tp = _ref_params(jcfg)
    want, _, _ = _ref_round(name, "xla")
    init = {k: tp[k].float().numpy() for k in want}
    assert max(float(np.abs(w - init[k]).max())
               for k, w in want.items()) >= 2 * BF16_PARAM_ATOL
    assert min(_update_rel(init, want, tp)[0].values()) == 1.0
    one, _, total = _ref_round(name, "xla", weight_scale=(1.0, 0.0))
    assert total == 4.0
    groups, leaves = _update_rel(one, want, tp)
    assert not _within((groups, leaves))
    assert groups["torch.bfloat16"] >= _CONTROL_MIN, groups


# -- the fold alone -------------------------------------------------------------
def _lane_inputs():
    rng = np.random.default_rng(5)
    acc, theta = (rng.standard_normal((3, 4096)).astype(np.float32)
                  for _ in range(2))
    return (acc, theta, np.array([3.0, 0.0, 7.0], np.float32),
            np.array([5.0, 2.0, 0.0], np.float32))


def _ref_fold(jimpl):
    acc, theta, n_old, n_k = _lane_inputs()
    ja, jt = (jnp.asarray(x, jnp.bfloat16) for x in (acc, theta))
    out = []
    for lane in range(acc.shape[0]):
        p = jagg.PartialAggregate({"w": ja[lane]}, jnp.float32(n_old[lane]))
        out.append(_as_f32(jagg.partial_update(p, {"w": jt[lane]},
                                               n_k[lane],
                                               impl=jimpl).theta["w"]))
    return np.stack(out)


def _port_fold(timpl):
    acc, theta, n_old, n_k = _lane_inputs()
    p = tagg.PartialAggregate(
        {"bfloat16": torch.from_numpy(acc).bfloat16()},
        torch.from_numpy(n_old))
    out = tagg.partial_update(p, {"bfloat16": torch.from_numpy(theta)
                                  .bfloat16()}, torch.from_numpy(n_k),
                              impl=timpl)
    assert out.theta["bfloat16"].dtype == torch.bfloat16
    return out.theta["bfloat16"].float().numpy()


@pytest.mark.parametrize("impls", [("plain", "xla"), ("kernel", "pallas")])
def test_bf16_fold_routes_match_reference_bitwise(impls):
    """Eq. 1 on bf16 lane buffers with per-lane weights (a blend, a cold
    start, a skipped lane): each port route bitwise its reference route,
    and the other route differs from it, so the two folds are told
    apart."""
    timpl, jimpl = impls
    got = _port_fold(timpl)
    np.testing.assert_array_equal(got, _ref_fold(jimpl))
    other = _port_fold({"plain": "kernel", "kernel": "plain"}[timpl])
    assert (got != other).mean() > 0.05


def test_bf16_lane_mean_matches_reference_bitwise():
    """The round's reduce (``tree_weighted_mean``) on bf16 lanes."""
    acc, _, n_old, _ = _lane_inputs()
    w = n_old + 1.0
    want = _as_f32(jagg.tree_weighted_mean(
        {"w": jnp.asarray(acc, jnp.bfloat16)}, jnp.asarray(w))["w"])
    got = tagg.tree_weighted_mean({"w": torch.from_numpy(acc).bfloat16()},
                                  torch.from_numpy(w))["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_mixed_round_folds_once_per_dtype_group(monkeypatch):
    """K1's route is called once per dtype group a lane-loop step: twice
    for a mixed tree, once for the same tree in f32."""
    calls = []
    fold = tagg.kops.fedavg_accum

    def counting(acc, theta, n_old, n_k):
        calls.append(acc.dtype)
        return fold(acc, theta, n_old, n_k)

    monkeypatch.setattr(tagg.kops, "fedavg_accum", counting)
    jcfg, tcfg = _cfgs("qwen3-0.6b")
    _, tp = _ref_params(jcfg)
    batch, ones, boundary, weight = _round_inputs(jcfg, S=3)
    args = ({k: torch.from_numpy(v) for k, v in batch.items()},
            *(torch.from_numpy(a) for a in (ones, boundary, weight)))
    for cfg, tree, want in (
            (tcfg, tp, [torch.bfloat16, torch.float32] * 3),
            (replace(tcfg, dtype="float32"),
             {k: v.float() for k, v in tp.items()}, [torch.float32] * 3)):
        calls.clear()
        tround_step(tmodels.make_lane_loss_fn(cfg), tsgd(0.05, 0.9))(
            tree, *args)
        assert calls == want


# -- the engine ----------------------------------------------------------------------
def test_bf16_engine_bitwise_across_depths():
    """``build_engine(lm_cfg=<reduced qwen3 in bf16>)`` trains two rounds on
    the fused path, finite and bit-identical at pipeline depths 0/1/2."""
    cfg = replace(tconfigs.get_arch("qwen3-0.6b").reduced(),
                  dtype="bfloat16")
    runs = {}
    for depth in (0, 1, 2):
        eng = build_engine(lm_cfg=cfg, device="cpu", pipeline_depth=depth,
                           cohort=4, steps_cap=2)
        runs[depth] = [r.loss for r in eng.run(2)]
        dtypes = {v.dtype for v in flatten_tree(eng.params).values()}
        assert dtypes == {torch.bfloat16, torch.float32}
    assert all(np.isfinite(runs[0]))
    assert runs[0] == runs[1] == runs[2]
