"""The mesh, tree, host, compressed-combine and FedMedian paths on a tree of
several dtypes (a published LM config: bf16 matrices beside f32 norm scales
and Mamba rows), in the port, held against the JAX reference on the CPU.

Every program takes the params' group buffers (one flat buffer per dtype,
``FlatLayout.groups``) and computes each group in its own dtype, as the
reference computes each leaf in its own; the compression family works on
the f32 twin (``FlatLayout.twin``).  Inputs are made with numpy from a seed
and handed to both packages; bf16 values cross as their 16 bits
(``lm_params_from_numpy``), so both see the same numbers.

Tolerances, and why:

* wherever clients train: PR 23's bf16 tolerances (``BF16_*`` of
  ``test_torch_mixed_dtype``).  The worker and gather steps: loss rtol
  1e-3, params atol 2^-7, the update within 0.1 of the reference's in
  relative norm over each dtype group and 0.3 over each leaf.  The
  engines: losses rtol 1e-3 and params atol 2^-7 after each round, not
  the update measure: the reference compiles the round's weighted mean,
  and XLA computes its bf16 chain in f32 and rounds once (its
  excess-precision rule) where the port rounds each op as the reference
  does op by op (``test_bf16_lane_mean_matches_reference_bitwise``).  An
  update is of the order of one bf16 ulp of its weight, so one round at
  cohort 4 differs by 0.06 (int8) to 0.43 (tree) in the bf16 group's
  relative norm, the fused path of PR 23 by 0.23 (measured);
* bitwise, route for route, for what no client step feeds and the
  reference runs op by op: the host node (Eq. 1 in each group's dtype),
  the flat combine's weighted mean, the f32 compression family's encode
  and decode (and their residuals) and the FedMedian reduce
  (``jnp.median``'s midpoint, NaN columns included);
* within ``SCAN_ULPS`` = 1 unit in the last place of each leaf's dtype
  where the reference folds inside a compiled ``lax.scan`` (the shard
  merge, the compressed combine), an ulp taken at the magnitude of the
  fold's largest input: XLA contracts its ``a·n + b·m`` into a fused
  multiply-add, rounding once where PyTorch rounds each product.
  Measured on these inputs: f32 leaves within 0.5 ulp (the shard merge)
  and 0.25 (the int8 combine, both routes; topk bitwise), every bf16 leaf
  bitwise;
* within the port: bitwise (the flat mesh against the fused path, depths
  0/1/2 and both bucket modes, ``hosts=2`` against ``hosts=1``, spawned
  ranks against the in-process run, and error feedback's ``sent + e_new
  == u``).

The engines train the reduced qwen3-0.6b in bf16 (cohort 4 over 4 workers
of one lane, 2 local steps a client, 2 rounds); each run is shared through
a cache by the tests that read it.
"""

import functools
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _torch_parity import one_intra_op_thread  # noqa: E402,F401
from _torch_small_engine import build_small_lm_engine  # noqa: E402
from test_torch_mixed_dtype import (BF16_LOSS_RTOL,  # noqa: E402
                                    BF16_PARAM_ATOL, _update_rel, _within)
from repro import configs as jconfigs  # noqa: E402
from repro.compress import make_encode_step as jencode  # noqa: E402
from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.core import FederatedEngine as JEngine  # noqa: E402
from repro.core import SyntheticTelemetry as JTelemetry  # noqa: E402
from repro.core import UniformSampler as JSampler  # noqa: E402
from repro.core import make_placement as jplacement  # noqa: E402
from repro.data import federated as jfed  # noqa: E402
from repro.distributed import WorkerPool as JPool  # noqa: E402
from repro.fl import round as jround  # noqa: E402
from repro.fl import strategy as jstrategy  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import make_loss_fn as jmake_loss_fn  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.compress import make_encode_step as tencode  # noqa: E402
from repro_torch.core import EngineConfig as TConfig  # noqa: E402
from repro_torch.core import FederatedEngine as TEngine  # noqa: E402
from repro_torch.core import SyntheticTelemetry as TTelemetry  # noqa: E402
from repro_torch.core import UniformSampler as TSampler  # noqa: E402
from repro_torch.core import make_placement as tplacement  # noqa: E402
from repro_torch.distributed import WorkerPool as TPool  # noqa: E402
from repro_torch.fl import round as tround  # noqa: E402
from repro_torch.fl import strategy as tstrategy  # noqa: E402
from repro_torch.kernels.layout import FlatLayout, flatten_tree  # noqa: E402
from repro_torch.launch.multihost import run_multihost  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402

NAMES = ["qwen3-0.6b", "mamba2-2.7b"]
SEED = 1337
COHORT, WORKERS, STEPS_CAP, BATCH, SEQ = 4, 4, 2, 2, 16
ROUNDS = 2
FRAC = 0.1


@functools.lru_cache(maxsize=None)
def _cfgs(name):
    return (replace(jconfigs.get_arch(name).reduced(), dtype="bfloat16"),
            replace(tconfigs.get_arch(name).reduced(), dtype="bfloat16"))


@functools.lru_cache(maxsize=None)
def _ref_numpy(name):
    """The reference's weights of ``name``, nested, as numpy (bf16 leaves as
    ``ml_dtypes.bfloat16``)."""
    return jax.tree.map(np.asarray, jlm.init_params(jax.random.key(0),
                                                    _cfgs(name)[0]))


def _jparams(name):
    """A fresh copy (the reference's engine donates its params)."""
    return jax.tree.map(jnp.asarray, _ref_numpy(name))


def _tparams(name) -> dict:
    return flatten_tree(tmodels.lm_params_from_numpy(_ref_numpy(name),
                                                     device="cpu"))


def _paths(tree):
    return ["/".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _jflat(tree) -> dict:
    return dict(zip(_paths(tree), jax.tree.leaves(tree)))


@functools.lru_cache(maxsize=None)
def _leaves(name) -> dict:
    """``{path: (shape, dtype name)}`` of the config's params."""
    return {k: (tuple(v.shape), v.dtype.name)
            for k, v in _jflat(_ref_numpy(name)).items()}


def _pair(x: np.ndarray, dtype: str):
    """One f32 numpy draw as a (jax, torch) pair of the same values in
    ``dtype``: bf16 rounds once, in numpy, and crosses as its bits."""
    if dtype == "bfloat16":
        xb = x.astype(jnp.bfloat16)
        return (jnp.asarray(xb), torch.from_numpy(
            xb.view(np.int16).copy()).view(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _rand_tree(name, lead, seed, *, dtype=None, scale=1.0):
    """A random tree of the config's leaves with lead dims ``lead``, in each
    leaf's dtype (or ``dtype`` for all): ``({path: jax}, {path: torch})``."""
    rng = np.random.default_rng(seed)
    j, t = {}, {}
    for k, (shape, dt) in sorted(_leaves(name).items()):
        x = (rng.standard_normal(tuple(lead) + shape) * scale).astype(
            np.float32)
        j[k], t[k] = _pair(x, dtype or dt)
    return j, t


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _same(got: dict, want: dict) -> None:
    """Bitwise equal, leaf by leaf, in the same dtypes (NaN where NaN)."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
        np.testing.assert_array_equal(_f32(got[k]), _f32(w), err_msg=k)


SCAN_ULPS = 1
# What each check measured, recorded beside the bound it is held to.
_MEASURED = {}


def _ulps(got: dict, want: dict, inputs: dict) -> dict:
    """The largest distance of each dtype's leaves from the reference's, in
    units of the last place of that dtype (bf16 has 16 fewer bits than f32)
    at the magnitude of the leaf's largest input to the fold: a weighted
    mean that cancels to near 0 carries the rounding of its terms, not of
    its result.  Leaf dtypes must match."""
    out = {}
    for k, w in want.items():
        dt = str(w.dtype)
        assert str(got[k].dtype).removeprefix("torch.") == dt, k
        g, w = _f32(got[k]), _f32(w)
        mag = np.float32(float(inputs[k].abs().max()))
        ulp = np.spacing(mag) * (65536 if dt == "bfloat16" else 1)
        out[dt] = max(out.get(dt, 0.0), float(np.abs(g - w).max() / ulp))
    return out


def _n(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


# -- the f32 twin --------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_f32_twin_round_trip(name):
    """The twin holds the layout's names and shapes in its order as one f32
    layout; a mixed tree goes in exactly (bf16 widens without rounding)
    and comes back to its group buffers bit for bit; a single-dtype f32
    layout is its own twin."""
    tree = _tparams(name)
    layout = FlatLayout(tree)
    twin = layout.twin
    assert layout.mixed and not twin.mixed and twin.dtypes[0] == torch.float32
    assert (twin.names, twin.shapes) == (layout.names, layout.shapes)
    flat = layout.to_twin(tree)
    for k, v in twin.views(flat).items():
        assert torch.equal(v, tree[k].float()), k
    back = layout.from_twin(flat)
    for key, f in layout.flatten_groups(tree).items():
        assert back[key].dtype == f.dtype and torch.equal(back[key], f)
    f32 = FlatLayout({k: v.float() for k, v in tree.items()})
    assert f32.twin is f32


# -- the worker and gather steps (clients train) ----------------------------
def _block(cfg, W=1, P=2, S=2):
    """A worker's ``[W, P, S]`` block: 2 steps a lane, one client each."""
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (W, P, S, BATCH, SEQ)).astype(np.int32)
    ones = np.ones((W, P, S), np.float32)
    boundary = np.zeros((W, P, S), np.float32)
    boundary[:, :, -1] = 1.0
    return {"tokens": tokens}, ones, boundary, boundary * 4.0


def _run_both(name, jstep, tstep):
    jcfg, _ = _cfgs(name)
    batch, ones, boundary, weight = _block(jcfg)
    want = jstep(_jparams(name), {k: jnp.asarray(v) for k, v in
                                  batch.items()},
                 *map(jnp.asarray, (ones, boundary, weight)))
    got = tstep(_tparams(name), {k: torch.from_numpy(v) for k, v in
                                 batch.items()},
                *map(torch.from_numpy, (ones, boundary, weight)))
    return got, want


def _lanes_within(got: dict, want: dict, init: dict, lanes: int) -> None:
    """Each lane's trained params ``[lanes, ...]`` within the bf16 training
    tolerances of the reference's, in the params' dtypes."""
    for k, v in init.items():
        assert got[k].dtype == v.dtype, k
    for lane in range(lanes):
        g = {k: _f32(v.reshape((lanes,) + init[k].shape)[lane])
             for k, v in got.items()}
        w = {k: _f32(v.reshape((lanes,) + init[k].shape)[lane])
             for k, v in want.items()}
        worst = max(float(np.abs(g[k] - w[k]).max()) for k in w)
        assert worst <= BF16_PARAM_ATOL, (lane, worst)
        assert _within(_update_rel(g, w, init)), lane


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("impls", [("plain", "xla"), ("kernel", "pallas")])
def test_worker_step_matches_the_reference(name, impls):
    """One worker's ``[1, 2, 2]`` block: unreduced lane partials ``[1, 2,
    ...]`` in each leaf's dtype, K1's two routes against the reference's."""
    timpl, jimpl = impls
    jcfg, tcfg = _cfgs(name)
    (tth, tn, tl), (jth, jn, jl) = _run_both(
        name,
        jround.make_worker_round_step(jmake_loss_fn(jcfg), jsgd(0.05, 0.9),
                                      agg_impl=jimpl),
        tround.make_worker_round_step(tmodels.make_lane_loss_fn(tcfg),
                                      tsgd(0.05, 0.9), agg_impl=timpl))
    assert tth.layout.mixed and set(tth.flats) == {"bfloat16", "float32"}
    assert all(f.shape[:2] == (1, 2) for f in tth.flats.values())
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               rtol=BF16_LOSS_RTOL)
    _lanes_within(dict(tth), _jflat(jth), _tparams(name), 2)


@pytest.mark.parametrize("name", NAMES)
def test_gather_step_matches_the_reference(name):
    """The gather path's lanes come back as ``{dtype group: [W·P, n_g]}``,
    each lane within the training tolerances of the reference's."""
    jcfg, tcfg = _cfgs(name)
    (tth, tw, tm), (jth, jw, jm) = _run_both(
        name, jround.make_gather_round_step(jmake_loss_fn(jcfg),
                                            jsgd(0.05, 0.9)),
        tround.make_gather_round_step(tmodels.make_lane_loss_fn(tcfg),
                                      tsgd(0.05, 0.9)))
    layout = FlatLayout(_tparams(name))
    assert list(tth) == list(layout.keys)
    assert {k: tuple(v.shape) for k, v in tth.items()} == {
        k: (2, g.n) for k, g in zip(layout.keys, layout.groups)}
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert abs(float(tm.loss) - float(jm.loss)) <= \
        BF16_LOSS_RTOL * abs(float(jm.loss))
    _lanes_within(dict(layout.views(tth)), _jflat(jth), _tparams(name), 2)


# -- the merges and the combine (bitwise) -----------------------------------
def _masks(lead, S=3):
    rng = np.random.default_rng(9)
    step = (rng.uniform(size=lead + (S,)) > 0.3).astype(np.float32)
    bnd = step * (rng.uniform(size=lead + (S,)) > 0.5)
    return step, bnd, bnd * 3.0


@pytest.mark.parametrize("name", NAMES)
def test_flat_combine_matches_the_reference_bitwise(name):
    """The mesh's flat combine over ``[2, 2, ...]`` lane partials (one lane
    of weight 0): the weighted mean in each group's dtype."""
    jg, tg = _rand_tree(name, (), 1)
    jth, tth = _rand_tree(name, (2, 2), 2)
    n = np.asarray([[4.0, 0.0], [6.0, 2.0]], np.float32)
    ls = np.asarray([[1.5, 0.0], [2.25, 0.75]], np.float32)
    masks = _masks((2, 2))
    jnew, jm = jround.make_combine_step()(jg, jth, jnp.asarray(n),
                                          jnp.asarray(ls),
                                          *map(jnp.asarray, masks))
    tnew, tm = tround.make_combine_step()(tg, tth, _n(n), _n(ls),
                                          *map(_n, masks))
    _same(tnew, jnew)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", NAMES)
def test_shard_merge_and_host_node_match_the_reference(name):
    """Eq. 1's pairwise merge in each group's dtype: a shard's ``[2, 2]``
    lanes folded left to right (one of weight 0; the reference's scan,
    within ``SCAN_ULPS``), and one host node (bitwise)."""
    jth, tth = _rand_tree(name, (2, 2), 3)
    n = np.asarray([[3.0, 0.0], [5.0, 1.0]], np.float32)
    ls = np.asarray([[0.5, 0.0], [0.25, 1.0]], np.float32)
    jm = jround.make_shard_merge_step()(jth, jnp.asarray(n), jnp.asarray(ls))
    tm = tround.make_shard_merge_step()(tth, _n(n), _n(ls))
    _MEASURED[("shard merge", name)] = got = _ulps(tm[0], _jflat(jm[0]), tth)
    assert max(got.values()) <= SCAN_ULPS, _MEASURED
    for a, b in zip(tm[1:], jm[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    (ja, ta), (jb, tb) = _rand_tree(name, (), 4), _rand_tree(name, (), 5)
    jn = jround.make_host_node_merge_step()(
        ja, jnp.float32(3.0), jnp.float32(0.5),
        jb, jnp.float32(5.0), jnp.float32(0.25))
    tn = tround.make_host_node_merge_step()(
        ta, torch.tensor(3.0), torch.tensor(0.5),
        tb, torch.tensor(5.0), torch.tensor(0.25))
    _same(tn[0], jn[0])
    for a, b in zip(tn[1:], jn[1:]):
        assert float(a) == float(b)


# -- the compression family on the f32 twin (bitwise) -----------------------
def _encode_inputs(name, seed):
    """A global model, a shard's merged partial near it (each leaf in its
    own dtype) and a carried f32 residual."""
    jg, tg = _rand_tree(name, (), seed)
    jd, td = _rand_tree(name, (), seed + 1, scale=0.01)
    jth = {k: (jg[k].astype(jnp.float32) + jd[k].astype(jnp.float32))
           .astype(jg[k].dtype) for k in jg}
    tth = {k: (tg[k].float() + td[k].float()).to(tg[k].dtype) for k in tg}
    je, te = _rand_tree(name, (), seed + 2, dtype="float32", scale=1e-3)
    return (jg, jth, je), (tg, tth, te)


def _dense(payload: dict, like: dict) -> dict:
    """A topk payload ``{path: (idx, vals)}`` scattered into f32 leaves."""
    out = {}
    for k, (idx, vals) in payload.items():
        d = np.zeros(int(np.prod(like[k][0])), np.float32)
        d[np.asarray(idx).astype(np.int64)] = _f32(vals)
        out[k] = d.reshape(like[k][0])
    return out


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_encode_matches_the_reference_bitwise(name, mode):
    """``u = θ·f32 − g·f32 + e`` per leaf in f32: the int8 codes, their f32
    scales and the new f32 residual, or the top-k values (scattered: the
    index order may differ) and residual, bit for bit."""
    (jg, jth, je), (tg, tth, te) = _encode_inputs(name, 10)
    jpay, jres = jencode(mode, FRAC)(jg, jth, je)
    tpay, tres = tencode(mode, FRAC)(tg, tth, te)
    _same(tres, jres)
    if mode == "int8":
        _same(tpay[0], jpay[0])
        _same(tpay[1], jpay[1])
    else:
        want = _dense(jpay, _leaves(name))
        for k, v in _dense(tpay, _leaves(name)).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_error_feedback_is_conserved_on_a_mixed_tree(mode):
    """What is sent plus the new residual is ``u`` exactly, in f32, for
    every leaf of both dtypes."""
    name = NAMES[0]
    _, (tg, tth, te) = _encode_inputs(name, 20)
    pay, res = tencode(mode, FRAC)(tg, tth, te)
    assert {v.dtype for v in res.values()} == {torch.float32}
    for k in sorted(tg):
        u = tth[k].float() - tg[k].float() + te[k]
        if mode == "int8":
            sent = pay[0][k].float() * pay[1][k]
        else:
            sent = torch.from_numpy(_dense({k: pay[k]}, _leaves(name))[k])
        assert torch.equal(sent + res[k], u), k
        assert torch.count_nonzero(sent) > 0, k


def _payloads(name, mode, k):
    """``k`` shard payloads encoded by the reference from its own inputs:
    (the first alone, all stacked) for each package."""
    pays = []
    for s in range(k):
        (jg, jth, je), _ = _encode_inputs(name, 30 + 3 * s)
        pays.append(jencode(mode, FRAC)(jg, jth, je)[0])
    jstack = jax.tree.map(lambda *xs: jnp.stack(xs), *pays)

    def conv(x):
        return torch.from_numpy(np.array(x, copy=True))

    def port(p):
        if mode == "int8":
            return tuple({k_: conv(v) for k_, v in part.items()}
                         for part in p)
        return {k_: (conv(i), conv(v)) for k_, (i, v) in p.items()}

    return (pays[0], port(pays[0])), (jstack, port(jstack))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_decode_matches_the_reference_bitwise(name, mode):
    """``g·f32 + dequant(payload)``: a dense f32 tree over every leaf."""
    jg, tg = _rand_tree(name, (), 40)
    (jone, tone), _ = _payloads(name, mode, 1)
    want = jround.make_payload_decode_step(mode)(jg, jone)
    got = tround.make_payload_decode_step(mode)(tg, tone)
    assert {v.dtype for v in got.values()} == {torch.float32}
    _same(got, want)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mode,jimpl", [("int8", "xla"), ("int8", "pallas"),
                                        ("topk", "xla")])
def test_compressed_combine_matches_the_reference(name, mode, jimpl):
    """Three shard payloads (one of weight 0) folded on the f32 twin (K2's
    route for int8: its plain version on the CPU), cast back to each leaf's
    dtype, within ``SCAN_ULPS`` of the reference's XLA fold and of its
    Pallas kernel in interpret mode (both inside its scan)."""
    jg, tg = _rand_tree(name, (), 41)
    _, (jstack, tstack) = _payloads(name, mode, 3)
    n = np.asarray([4.0, 0.0, 6.0], np.float32)
    ls = np.asarray([0.5, 0.0, 1.25], np.float32)
    masks = _masks((2, 2))
    jnew, jm = jround.make_compressed_combine_step(mode, agg_impl=jimpl)(
        jg, jstack, jnp.asarray(n), jnp.asarray(ls),
        *map(jnp.asarray, masks))
    tnew, tm = tround.make_compressed_combine_step(mode)(
        tg, tstack, _n(n), _n(ls), *map(_n, masks))
    thetas = {k: tg[k].float().abs() + 1.0 for k in tg}
    _MEASURED[(mode, jimpl, name)] = got = _ulps(tnew, jnew, thetas)
    assert max(got.values()) <= SCAN_ULPS, _MEASURED
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -- FedMedian (bitwise) ------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("lanes", [4, 5])
def test_fedmedian_reduce_is_bitwise_jnp_median(name, lanes):
    """The coordinate-wise median of each dtype group, in its dtype, bit for
    bit ``jnp.median(x, axis=0).astype(g.dtype)`` — with a NaN, +inf and
    -inf put into some columns of both dtypes (NaN exactly where a column
    holds one)."""
    jx, tx = _rand_tree(name, (lanes,), 50)
    jg, tg = _rand_tree(name, (), 51)
    for k in sorted(jx)[:4]:
        a = np.array(_f32(jx[k]))
        flat = a.reshape(lanes, -1)
        flat[1, 0], flat[0, 1], flat[2, 2] = np.nan, np.inf, -np.inf
        flat[:, 3] = np.inf
        jx[k], tx[k] = _pair(a, str(jx[k].dtype))
    want = jstrategy.FedMedian().reduce(jx, None, jg)
    layout = FlatLayout(tg)
    got = layout.views(tstrategy.FedMedian().reduce(
        layout.flatten_groups(tx, (lanes,)), None, layout.flatten_groups(tg)))
    _same(got, want)
    assert any(np.isnan(_f32(v)).any() for v in got.values())


# -- the engines ---------------------------------------------------------------
OPTIONS = {
    "fused": {},
    "flat": dict(mesh_workers=2),
    "tree": dict(mesh_workers=2, combine_mode="tree"),
    "hosts": dict(mesh_workers=2, combine_mode="tree", hosts=2),
    "int8": dict(mesh_workers=2, combine_mode="tree", combine_compress="int8"),
    "topk": dict(mesh_workers=2, combine_mode="tree", combine_compress="topk"),
    "fedmedian": dict(strategy="fedmedian"),
}


@functools.lru_cache(maxsize=None)
def _dataset(vocab):
    return jfed.make_federated_dataset(
        "lm", seed=SEED, vocab_size=vocab, seq_len=SEQ, batch_size=BATCH,
        n_clients=64, size_mu=2.0, size_sigma=0.8)


def _engine(port: bool, name: str, *, strategy="fedavg", depth=1, **cfg):
    jcfg, tcfg = _cfgs(name)
    ds = _dataset(jcfg.vocab_size)
    if port:
        return TEngine(
            dataset=ds, loss_fn=tmodels.make_lane_loss_fn(tcfg),
            init_params=_tparams(name), optimizer=tsgd(0.05, 0.9),
            placement=tplacement("lb"),
            sampler=TSampler(ds.n_clients, COHORT, seed=SEED),
            pool=TPool.homogeneous(WORKERS, type_name="a40", concurrency=1),
            telemetry=TTelemetry(seed=SEED),
            strategy=tstrategy.strategy_from_name(strategy),
            config=TConfig(steps_cap=STEPS_CAP, batch_size=BATCH,
                           seq_len=SEQ, lanes_per_worker=1,
                           combine_topk_frac=FRAC, pipeline_depth=depth,
                           **cfg),
            device="cpu")
    return JEngine(
        dataset=ds, loss_fn=jmake_loss_fn(jcfg), init_params=_jparams(name),
        optimizer=jsgd(0.05, 0.9), placement=jplacement("lb"),
        sampler=JSampler(ds.n_clients, COHORT, seed=SEED),
        pool=JPool.homogeneous(WORKERS, type_name="a40", concurrency=1),
        telemetry=JTelemetry(seed=SEED),
        strategy=jstrategy.strategy_from_name(strategy),
        config=JConfig(steps_cap=STEPS_CAP, batch_size=BATCH, seq_len=SEQ,
                       seed=SEED, lanes_per_worker=1, combine_topk_frac=FRAC,
                       **cfg))


def _run(port: bool, option: str, name: str = NAMES[0], depth: int = 1,
         **over):
    """``(results, {path: final param}, engine, {path: param after the
    first round})`` of one engine's ``ROUNDS`` rounds, shared by the tests
    that read it."""
    return _cached_run(port, name, depth,
                       tuple(sorted({**OPTIONS[option], **over}.items())))


@functools.lru_cache(maxsize=None)
def _cached_run(port: bool, name: str, depth: int, cfg: tuple):
    eng = _engine(port, name, depth=depth, **dict(cfg))

    def params():
        if port:
            return {k: v.clone() for k, v in flatten_tree(eng.params).items()}
        return {k: np.asarray(v) for k, v in _jflat(eng.params).items()}

    res = eng.run(1)
    first = params()
    res += eng.run(ROUNDS - 1)
    return res, params(), eng, first


@pytest.mark.parametrize("option", sorted(set(OPTIONS) - {"fused"}))
def test_engine_tracks_the_reference(option):
    """Each path on both packages' engines, from the same weights and
    dataset: the same cohorts and step counts, losses within rtol 1e-3,
    the same ``combine_bytes`` every round, and the params in their dtypes
    within 2^-7 after each round, where the reference's moved some param
    by more than that (so params left untrained fail).  Measured: params
    within 9.8e-4 (FedMedian) to 3.9e-3 (tree) of the reference's, which
    moved them by up to 9.2e-3 (FedMedian) and 0.039."""
    tres, tp, _, tfirst = _run(True, option)
    jres, jp, _, jfirst = _run(False, option)
    for t, j in zip(tres, jres):
        assert (t.n_clients, t.s_steps) == (j.n_clients, j.s_steps)
        assert t.combine_bytes == j.combine_bytes
        assert abs(t.loss - j.loss) <= BF16_LOSS_RTOL * abs(j.loss)
    init = _tparams(NAMES[0])
    for got, want in ((tfirst, jfirst), (tp, jp)):
        for k, v in init.items():
            assert got[k].dtype == v.dtype, k
        worst = max(float(np.abs(_f32(got[k]) - _f32(w)).max())
                    for k, w in want.items())
        moved = max(float(np.abs(_f32(init[k]) - _f32(w)).max())
                    for k, w in want.items())
        _MEASURED[("engine", option)] = (worst, moved)
        assert worst <= BF16_PARAM_ATOL < moved, _MEASURED


def test_partial_bytes_track_the_reference():
    """A dense partial is each leaf at its own element size (2 bytes a bf16
    value) plus the weight and loss scalars, as the reference counts it;
    the int8 payload is a byte a value plus one f32 scale a leaf."""
    teng, jeng = _run(True, "int8")[2], _run(False, "int8")[2]
    init = _tparams(NAMES[0])
    dense = sum(v.numel() * v.element_size() for v in init.values()) + 8
    assert teng._partial_bytes == jeng._partial_bytes == dense
    assert teng._compress.payload_bytes == jeng._compress.payload_bytes == \
        sum(v.numel() + 4 for v in init.values()) + 8
    assert _run(True, "tree")[0][0].combine_bytes == 2 * dense


def _same_run(a, b) -> None:
    assert [r.loss for r in a[0]] == [r.loss for r in b[0]]
    assert sorted(a[1]) == sorted(b[1])
    for k, v in a[1].items():
        assert v.dtype == b[1][k].dtype and torch.equal(v, b[1][k]), k


def test_flat_mesh_is_bitwise_the_fused_path():
    _same_run(_run(True, "flat"), _run(True, "fused"))


@pytest.mark.parametrize("depth,bucket", [(0, "round"), (2, "round"),
                                          (1, "worker"), (0, "worker")])
@pytest.mark.parametrize("option", ["tree", "int8"])
def test_mesh_bitwise_across_depths_and_bucket_modes(option, depth, bucket):
    _same_run(_run(True, option, depth=depth, bucket_mode=bucket),
              _run(True, option))


@pytest.mark.parametrize("option", ["hosts", "int8"])
def test_hosts_2_is_bitwise_hosts_1(option):
    _same_run(_run(True, option, hosts=2), _run(True, option, hosts=1))


def test_spawned_ranks_on_a_mixed_tree():
    """Two spawned ranks train the bf16 config through the process-per-host
    harness: each rank the same losses, bitwise the in-process ``hosts=2``
    run (bf16 partials cross the pipes as their bits)."""
    kw = dict(arch=NAMES[0], dtype="bfloat16", workers=4, concurrency=1,
              mesh_workers=4, combine_mode="tree", hosts=2, cohort=COHORT,
              steps_cap=STEPS_CAP, seed=13, device="cpu")
    res = run_multihost(build_small_lm_engine, kw, hosts=2, rounds=ROUNDS)
    assert res.ok, res.reason
    assert res.per_rank_losses[0] == res.per_rank_losses[1]
    eng = build_small_lm_engine(**kw)
    assert res.losses == [r.loss for r in eng.run(ROUNDS)]
    assert all(np.isfinite(res.losses))
    dense = sum(v.numel() * v.element_size()
                for v in flatten_tree(eng.params).values())
    assert all(sorted(b) == [dense + 8] * 2 for b in res.exchange_bytes)
