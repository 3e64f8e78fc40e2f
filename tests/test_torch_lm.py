"""The port's LM serve path — configs, layers, ``forward``/``prefill``/
``decode_step`` — against the JAX reference on the CPU.

Inputs are made with numpy from a seed and given to both packages; the
reference's weights (``jax.random`` init) are carried across with
``lm_params_from_numpy``.  The reduced configs (``ArchConfig.reduced()``:
f32, 4 layers, d_model 64, head_dim 16, vocab 256) of the four dense
archs and of the two with a modality frontend (whisper-base: 2 encoder
layers over 16 frames, cross-attention, learned positions; internvl2-26b:
16 patch embeddings of width 32 in front of the text).  Tolerances, and
why:

* configs, layer plans, shapes: pure logic, exact;
* layers and whole models in f32: the two libraries sum GEMMs and
  reductions in other orders, and ``exp``/``cos``/``sin`` differ in the last
  bits: rtol 1e-5, atol 1e-5 (measured at most 3e-6 on logits up to 3.3);
* inside the port, prefill + decode against a teacher-forced forward:
  rtol 1e-5, atol 1e-5 (the reference's own test allows 2e-4/3e-4);
* bf16 (the serve path's dtype) on the reduced qwen3: both round their
  activations to bf16 at the same places, but sums in another order move a
  value to the neighbouring bf16 number now and then: atol 2e-2 on logits
  of magnitude ~0.5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from dataclasses import replace  # noqa: E402

from _torch_parity import one_intra_op_thread  # noqa: E402,F401
from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

DENSE = ["qwen3-0.6b", "minitron-4b", "internlm2-1.8b", "command-r-plus-104b"]
MOE = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "jamba-v0.1-52b"]
FRONTEND = ["whisper-base", "internvl2-26b"]
# The reference's param counts at the published widths (init_params under
# jax.eval_shape), and internvl2-26b cut to 12 of its 48 layers.
PUBLISHED = [("whisper-base", 0, 73_596_928),
             ("internvl2-26b", 0, 19_882_383_360),
             ("internvl2-26b", 12, 5_839_411_200)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(name, **kw):
    """The reduced config of ``name`` in both packages, with ``kw``."""
    return (replace(jconfigs.get_arch(name).reduced(), **kw),
            replace(tconfigs.get_arch(name).reduced(), **kw))


def _ref_params(jcfg, seed=0):
    p = jlm.init_params(jax.random.key(seed), jcfg)
    return p, tmodels.lm_params_from_numpy(jax.tree.map(np.asarray, p),
                                           device="cpu")


# -- configs ------------------------------------------------------------------
@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_configs_are_copies(name):
    j, t = jconfigs.get_arch(name), tconfigs.get_arch(name)
    assert t.to_dict() == j.to_dict()
    assert t.reduced().to_dict() == j.reduced().to_dict()
    assert tlm.layer_plan(t) == [tlm.LayerKind(k.mixer, k.mlp, k.cross)
                                 for k in jlm.layer_plan(j)]
    assert tmodels.make_batch_spec(t, batch=2, seq_len=16) == \
        jmodels.make_batch_spec(j, batch=2, seq_len=16)


def test_shape_cells_and_lookup_are_copies():
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert {k: vars(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: vars(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.get_arch("qwen3_0_6b").name == "qwen3-0.6b"
    with pytest.raises(KeyError):
        tconfigs.get_arch("gpt-5")


@pytest.mark.parametrize("name", DENSE + MOE + FRONTEND)
def test_block_shapes_match_at_published_widths(name):
    """The full config's parameter shapes, without allocating them (the
    encoder's blocks too)."""
    j, t = jconfigs.get_arch(name), tconfigs.get_arch(name)
    for jk, tk in zip(jlm.layer_plan(j), tlm.layer_plan(t)):
        assert tlm._block_shapes(t, tk) == jlm._block_shapes(j, jk)
    if j.enc_layers:
        je, te = j.encoder_cfg(), t.encoder_cfg()
        for jk, tk in zip(jlm.layer_plan(je, decoder=False),
                          tlm.layer_plan(te, decoder=False)):
            assert not tk.cross
            assert tlm._block_shapes(te, tk) == jlm._block_shapes(je, jk)


@pytest.mark.parametrize("name,n_layers,count", PUBLISHED)
def test_param_count_matches_the_published_size(name, n_layers, count):
    """``param_shapes`` at the published widths has the reference's tree,
    shapes and count (no weights drawn on either side)."""
    j, t = jconfigs.get_arch(name), tconfigs.get_arch(name)
    if n_layers:
        j, t = replace(j, n_layers=n_layers), replace(t, n_layers=n_layers)
    ref = jax.eval_shape(lambda k: jlm.init_params(k, j), jax.random.key(0))
    shapes = tlm.param_shapes(t)
    got = {"/".join(k.key for k in path): leaf for path, leaf in
           jax.tree_util.tree_flatten_with_path(shapes,
                                                is_leaf=_is_shape)[0]}
    want = {"/".join(k.key for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert got == want
    assert sum(int(np.prod(v)) for v in got.values()) == count


# jamba-v0.1-52b at its published widths: one 8-layer period (the serve
# cut) and the whole 32 layers; the reference's counts, 100 leaves each.
JAMBA_PUBLISHED = [(8, 13_267_598_848), (32, 51_459_770_368)]


def _ref_leaves(jcfg) -> dict:
    """``{path: (shape, dtype name)}`` of the reference's ``init_params``
    under ``jax.eval_shape`` (nothing drawn)."""
    ref = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                         jax.random.key(0))
    return {"/".join(k.key for k in path): (leaf.shape, leaf.dtype.name)
            for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}


@pytest.mark.parametrize("n_layers,count", JAMBA_PUBLISHED)
def test_jamba_param_shapes_and_dtypes_at_published_widths(n_layers, count):
    """jamba's ``param_shapes`` with each leaf's ``leaf_dtype``: the
    reference's tree leaf by leaf, in name, shape and dtype (bf16
    matrices; f32 norms and Mamba A, D and dt-bias rows)."""
    j = replace(jconfigs.get_arch("jamba-v0.1-52b"), n_layers=n_layers)
    t = replace(tconfigs.get_arch("jamba-v0.1-52b"), n_layers=n_layers)
    shapes = jax.tree_util.tree_flatten_with_path(tlm.param_shapes(t),
                                                  is_leaf=_is_shape)[0]
    got = {"/".join(k.key for k in path): (
               leaf, str(tlm.leaf_dtype(path[-1].key, t)).split(".")[-1])
           for path, leaf in shapes}
    want = _ref_leaves(j)
    assert list(got) == list(want)
    assert got == want
    assert len(got) == 100
    assert sum(int(np.prod(s)) for s, _ in got.values()) == count
    assert {d for _, d in got.values()} == {"bfloat16", "float32"}


def test_jamba_device_params_have_the_reference_layout():
    """``launch.steps.device_params`` of jamba at reduced widths in bf16 on
    the CPU: the reference's tree, shapes and dtypes, leaf by leaf."""
    from repro_torch.kernels.layout import flatten_tree
    from repro_torch.launch.steps import device_params
    jcfg, tcfg = _cfgs("jamba-v0.1-52b", dtype="bfloat16")
    got = flatten_tree(device_params(tcfg, 0, "cpu"))
    want = _ref_leaves(jcfg)
    assert sorted(got) == sorted(want)
    for k, (shape, dtype) in want.items():
        assert tuple(got[k].shape) == shape, k
        assert str(got[k].dtype).split(".")[-1] == dtype, k
        assert got[k].device.type == "cpu"


# -- layers -------------------------------------------------------------------
F32_EPS = float(np.finfo(np.float32).eps)
ROPE_CASES = [(10_000.0, 16, 40), (1_000_000.0, 128, 2064)]


def _ref_rope_freqs(hd, theta):
    """The reference's frequencies (``repro/models/layers.py:65``), on
    XLA's CPU ``exp``."""
    return np.asarray(jnp.exp(-jnp.arange(0, hd, 2, dtype=jnp.float32)
                              / hd * jnp.log(theta)))


@pytest.mark.parametrize("theta,hd,n", ROPE_CASES)
def test_rope_frequencies_within_one_ulp_of_reference(theta, hd, n):
    """(a) Each package takes ``exp`` from its own library, and a library's
    vector ``exp`` may round to the neighbouring f32 value: the port's
    frequencies are the reference's to within one f32 ulp (at hd 128, θ 1e6
    XLA's CPU ``exp`` and torch's differ on a few of the 64 frequencies,
    by one ulp, depending on the CPU)."""
    want = _ref_rope_freqs(hd, theta)
    got = tlayers.rope_freqs(hd, theta).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, ulps


@pytest.mark.parametrize("theta,hd,n", ROPE_CASES)
def test_rope_given_the_reference_frequencies_matches_it(theta, hd, n):
    """(b) Given the reference's frequencies, the port's angles (position
    times frequency, one f32 rounding) are bitwise the reference's, and
    its rotation agrees within 1e-6: only ``cos``/``sin`` differ, by an
    ulp or two of values at most 1, times inputs of a few units."""
    rng = _rng(1)
    x = _normal(rng, (2, n, 3, hd))
    for pos in (np.arange(n)[None, :], np.full((2, 1), n - 1)):
        xs = x if pos.shape[1] == n else x[:, -1:]
        freqs = _ref_rope_freqs(hd, theta)
        want_ang = np.asarray(jnp.asarray(pos).astype(jnp.float32)[..., None]
                              * jnp.asarray(freqs))
        ang = tlayers.rope_angles(torch.from_numpy(pos),
                                  torch.from_numpy(freqs.copy()))
        np.testing.assert_array_equal(ang.numpy(), want_ang)
        got = tlayers.rope_rotate(torch.from_numpy(xs), torch.cos(ang),
                                  torch.sin(ang))
        want = jlayers.rope(jnp.asarray(xs), jnp.asarray(pos), theta=theta)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("theta,hd,n", ROPE_CASES)
def test_rope_matches_reference(theta, hd, n):
    """(c) End to end, each output element is held to a bound computed from
    its inputs.  The angle ``pos·freq`` takes the frequency's error (≤ one
    ulp, check (a)) times the position, ``pos·ulp(freq)``, plus one ulp of
    the angle from the two products' roundings; an angle error δ moves
    ``x1·cos - x2·sin`` (and its pair) by at most ``δ·(|x1| + |x2|)``.  On
    top come f32 roundings of ``cos``, ``sin`` and the rotation,
    ``4·eps·(|x1| + |x2|)``.  At position 2,063 one ulp of the angle is
    2.4e-4 rad, so a fixed ``atol`` below that passes or fails with the
    CPU's vector ``exp``; the bound does not."""
    rng = _rng(1)
    x = _normal(rng, (2, n, 3, hd))
    freqs = _ref_rope_freqs(hd, theta)
    for pos in (np.arange(n)[None, :], np.full((2, 1), n - 1)):
        xs = x if pos.shape[1] == n else x[:, -1:]
        want = _np(jlayers.rope(jnp.asarray(xs), jnp.asarray(pos),
                                theta=theta))
        got = _np(tlayers.rope(torch.from_numpy(xs), torch.from_numpy(pos),
                               theta=theta))
        ang = pos.astype(np.float32)[..., None] * freqs     # [b, s, hd/2]
        dang = (pos[..., None] * np.spacing(freqs)
                + np.spacing(np.abs(ang)))
        x1, x2 = np.split(np.abs(xs), 2, axis=-1)            # [b, s, h, hd/2]
        mag = x1 + x2
        bound = (dang[..., None, :] + 4 * F32_EPS) * mag
        bound = np.concatenate([bound, bound], axis=-1)
        err = np.abs(got - want)
        assert (err <= bound).all(), float((err / bound).max())


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(impl, dtype):
    """bf16 activations with f32 scales, output in x's dtype."""
    rng = _rng(2)
    x = _normal(rng, (3, 7, 64))
    scale = _normal(rng, (64,))
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jlayers.rms_norm(jx, jnp.asarray(scale), eps=1e-6, impl=impl)
    got = tlayers.rms_norm(tx, torch.from_numpy(scale), eps=1e-6, impl=impl)
    assert got.dtype == tx.dtype
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("impl", ["dense", "chunked", "pallas"])
@pytest.mark.parametrize("b,s,hq,hkv,d", [(2, 37, 4, 2, 16),
                                           (1, 64, 6, 2, 32),
                                           (2, 20, 4, 4, 16)])
def test_gqa_attention_matches_reference(impl, b, s, hq, hkv, d):
    rng = _rng(3)
    q, k, v = (_normal(rng, (b, s, h, d)) for h in (hq, hkv, hkv))
    kw = dict(causal=True, impl=impl, q_chunk=16)
    want = jlayers.gqa_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = tlayers.gqa_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("kw", [dict(impl="dense", q_offset=5),
                                dict(impl="chunked", q_offset=5),
                                dict(impl="chunked", repeat_kv=True),
                                dict(impl="dense", causal=False),
                                dict(impl="chunked", causal=False)])
def test_gqa_attention_options_match_reference(kw):
    rng = _rng(4)
    q = _normal(rng, (2, 24, 4, 16))
    k, v = _normal(rng, (2, 29, 2, 16)), _normal(rng, (2, 29, 2, 16))
    kw = dict(kw, q_chunk=16)
    want = jlayers.gqa_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = tlayers.gqa_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("mask_kind", ["none", "1d", "2d"])
def test_decode_attention_matches_reference(mask_kind):
    rng = _rng(5)
    q = _normal(rng, (2, 1, 4, 16))
    kc, vc = _normal(rng, (2, 12, 2, 16)), _normal(rng, (2, 12, 2, 16))
    mask = {"none": None,
            "1d": (np.arange(12) <= 6).astype(np.float32),
            "2d": (np.arange(12)[None] <= np.array([[4], [9]]))
            .astype(np.float32)}[mask_kind]
    want = jlayers.decode_attention(
        *map(jnp.asarray, (q, kc, vc)),
        None if mask is None else jnp.asarray(mask))
    got = tlayers.decode_attention(
        *map(torch.from_numpy, (q, kc, vc)),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_mlps_match_reference():
    rng = _rng(6)
    x = _normal(rng, (3, 5, 16))
    wg, wu, wd = (_normal(rng, s) * 0.3 for s in ((16, 32), (16, 32),
                                                  (32, 16)))
    bu, bd = _normal(rng, (32,)), _normal(rng, (16,))
    np.testing.assert_allclose(
        _np(tlayers.swiglu(*map(torch.from_numpy, (x, wg, wu, wd)))),
        _np(jlayers.swiglu(*map(jnp.asarray, (x, wg, wu, wd)))), **TOL)
    np.testing.assert_allclose(
        _np(tlayers.gelu_mlp(*map(torch.from_numpy, (x, wu, bu, wd, bd)))),
        _np(jlayers.gelu_mlp(*map(jnp.asarray, (x, wu, bu, wd, bd)))), **TOL)
    # No biases (use_bias=False): the reference's form with zero biases.
    zu, zd = np.zeros_like(bu), np.zeros_like(bd)
    np.testing.assert_allclose(
        _np(tlayers.gelu_mlp(torch.from_numpy(x), torch.from_numpy(wu), None,
                             torch.from_numpy(wd), None)),
        _np(jlayers.gelu_mlp(*map(jnp.asarray, (x, wu, zu, wd, zd)))), **TOL)


def _is_shape(x):
    return isinstance(x, tuple)


# -- the model ----------------------------------------------------------------
def _tokens(cfg, b=2, s=14, seed=7):
    return _rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _stubs(cfg, b=2, seed=17):
    """The modality stub arrays ``cfg`` reads beside the tokens (numpy)."""
    rng = _rng(seed)
    if cfg.frontend == "patch":
        return {"patch_embed": _normal(rng, (b, cfg.frontend_len,
                                             cfg.resolved_frontend_dim))}
    if cfg.frontend == "audio":
        return {"frames": _normal(rng, (b, cfg.frontend_len, cfg.d_model))}
    return {}


def _serve_both(jcfg, tcfg, jp, tp, toks, s, stubs=None):
    """forward over all of ``toks``; prefill over the first ``s`` tokens,
    then decode the rest one by one — in both packages.  ``stubs``: the
    modality arrays (the same for every call); patches shift the decode
    positions by their count."""
    stubs = stubs or {}
    jstubs = {k: jnp.asarray(v) for k, v in stubs.items()}
    off = stubs["patch_embed"].shape[1] if "patch_embed" in stubs else 0
    out = {}
    out["jf"] = jlm.forward(jp, {"tokens": jnp.asarray(toks), **jstubs}, jcfg)
    out["tf"] = tlm.forward(tp, {"tokens": toks, **stubs}, tcfg,
                            device="cpu")
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s]), **jstubs},
                         jcfg, max_len=off + s + 4)
    tl, tc = tlm.prefill(tp, {"tokens": toks[:, :s], **stubs}, tcfg,
                         max_len=off + s + 4, device="cpu")
    out["jsteps"], out["tsteps"] = [jl], [tl]
    for i in range(toks.shape[1] - s):
        step = toks[:, s + i:s + i + 1]
        jl, jc = jlm.decode_step(jp, jc, jnp.asarray(step),
                                 jnp.int32(off + s + i), jcfg)
        tl, tc = tlm.decode_step(tp, tc, step, off + s + i, tcfg,
                                 device="cpu")
        out["jsteps"].append(jl)
        out["tsteps"].append(tl)
    out["jcache"], out["tcache"] = jc, tc
    return out


@pytest.mark.parametrize("impl", ["dense", "pallas"])
@pytest.mark.parametrize("name", DENSE)
def test_serve_path_matches_reference(name, impl):
    """forward, prefill and 2 decode steps on the reference's weights."""
    jcfg, tcfg = _cfgs(name, attn_impl=impl)
    jp, tp = _ref_params(jcfg)
    assert tlm.param_count(tp) == jlm.param_count(jp)
    toks = _tokens(jcfg)
    out = _serve_both(jcfg, tcfg, jp, tp, toks, 12)
    assert out["tf"].shape == (2, 14, tcfg.vocab_size)
    assert out["tf"].dtype == torch.float32
    np.testing.assert_allclose(_np(out["tf"]), _np(out["jf"]), **TOL)
    for jl, tl in zip(out["jsteps"], out["tsteps"]):
        assert tl.shape == (2, tcfg.padded_vocab)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for key, c in out["tcache"].items():
        for kv in ("k", "v"):
            np.testing.assert_allclose(_np(c[kv]),
                                       _np(out["jcache"][key][kv]), **TOL)


@pytest.mark.parametrize("name,impl", [("whisper-base", "dense"),
                                       ("internvl2-26b", "dense"),
                                       ("internvl2-26b", "pallas")])
def test_frontend_serve_path_matches_reference(name, impl):
    """forward (logits over the patch positions too), prefill and 2 decode
    steps on the reference's weights and stub inputs; the cache, the
    cross-attention k/v of the encoder output included."""
    jcfg, tcfg = _cfgs(name, attn_impl=impl)
    jp, tp = _ref_params(jcfg, seed=5)
    assert tlm.param_count(tp) == jlm.param_count(jp)
    stubs = _stubs(jcfg)
    out = _serve_both(jcfg, tcfg, jp, tp, _tokens(jcfg, seed=13), 12, stubs)
    s_tot = 14 + (tcfg.frontend_len if tcfg.frontend == "patch" else 0)
    assert out["tf"].shape == (2, s_tot, tcfg.vocab_size)
    np.testing.assert_allclose(_np(out["tf"]), _np(out["jf"]), **TOL)
    for jl, tl in zip(out["jsteps"], out["tsteps"]):
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    names = {"k", "v"} | ({"xk", "xv"} if tcfg.enc_layers else set())
    for key, c in out["tcache"].items():
        assert set(c) == names
        for name_ in names:
            assert c[name_].shape == out["jcache"][key][name_].shape
            np.testing.assert_allclose(_np(c[name_]),
                                       _np(out["jcache"][key][name_]), **TOL)


@pytest.mark.parametrize("name", FRONTEND)
def test_frontend_prefill_then_decode_equals_forward(name):
    """Inside the port, on its own weights: prefill + 2 decode steps ==
    the teacher-forced forward at the same (patch-shifted) positions, and
    the prefill runs the encoder once."""
    cfg = tconfigs.get_arch(name).reduced()
    params = tlm.init_params(0, cfg, device="cpu")
    toks, stubs = _tokens(cfg, s=14, seed=14), _stubs(cfg, seed=18)
    off = cfg.frontend_len if cfg.frontend == "patch" else 0
    full = tlm.forward(params, {"tokens": toks, **stubs}, cfg, device="cpu")
    calls = []
    real = tlm._run_encoder
    tlm._run_encoder = lambda *a: calls.append(1) or real(*a)
    try:
        lg, cache = tlm.prefill(params, {"tokens": toks[:, :12], **stubs},
                                cfg, max_len=off + 16, device="cpu")
    finally:
        tlm._run_encoder = real
    assert len(calls) == (1 if cfg.enc_layers else 0)
    np.testing.assert_allclose(_np(lg[:, :cfg.vocab_size]),
                               _np(full[:, off + 11]), **TOL)
    for i in range(2):
        lg, _ = tlm.decode_step(params, cache, toks[:, 12 + i:13 + i],
                                off + 12 + i, cfg, device="cpu")
        np.testing.assert_allclose(_np(lg[:, :cfg.vocab_size]),
                                   _np(full[:, off + 12 + i]), **TOL)


def test_whisper_pallas_attention_raises_in_both_packages():
    """The encoder and the cross-attention are non-causal over 16 frames,
    a key length the kernel wrapper would pad: both packages refuse it
    (``repro/kernels/ops.py:129-131``), before any launch."""
    jcfg, tcfg = _cfgs("whisper-base", attn_impl="pallas")
    jp, tp = _ref_params(jcfg)
    stubs = _stubs(jcfg)
    toks = _tokens(jcfg)
    with pytest.raises(NotImplementedError, match="non-causal padding"):
        jlm.forward(jp, {"tokens": jnp.asarray(toks),
                         **{k: jnp.asarray(v) for k, v in stubs.items()}},
                    jcfg)
    tops.reset_launch_counts()
    for call in (lambda: tlm.forward(tp, {"tokens": toks, **stubs}, tcfg,
                                     device="cpu"),
                 lambda: tlm.prefill(tp, {"tokens": toks, **stubs}, tcfg,
                                     device="cpu"),
                 lambda: tlm.loss_fn(tp, {"tokens": toks, **stubs}, tcfg,
                                     device="cpu")):
        with pytest.raises(NotImplementedError, match="non-causal padding"):
            call()
    assert tops.launch_counts()["flash_attention"] == 0


def test_loss_mask_leaves_out_the_patches():
    """internvl2's loss: the text positions alone predict (the mask is 0
    over the patches in front), so it equals the CE of ``forward``'s
    logits at positions ``P + i`` against token ``i + 1`` — in both
    packages."""
    jcfg, tcfg = _cfgs("internvl2-26b", vocab_size=200)
    jp, tp = _ref_params(jcfg, seed=6)
    toks, stubs = _tokens(jcfg, seed=15), _stubs(jcfg, seed=19)
    batch = {"tokens": toks, **stubs}
    x, mask, pos = tlm._embed_inputs(tp, batch, tcfg, torch.device("cpu"))
    P = tcfg.frontend_len
    assert x.shape[1] == P + 14 and pos.shape == (1, P + 14)
    assert bool((mask[:, :P] == 0).all()) and bool((mask[:, P:] == 1).all())
    logits = tlm.forward(tp, batch, tcfg, device="cpu").double()
    pred = logits[:, P:-1]
    gold = pred.gather(-1, torch.from_numpy(toks[:, 1:]).long()[..., None])
    want = float((torch.logsumexp(pred, -1) - gold[..., 0]).mean())
    got = tlm.loss_fn(tp, batch, tcfg, device="cpu")
    jgot = jlm.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                       jcfg)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    np.testing.assert_allclose(float(got), float(jgot), rtol=1e-5)


def test_bf16_vlm_serve_path_matches_reference():
    """internvl2 in the serve path's dtype through the kernel route: bf16
    weights, activations and patch projection (the projected patches equal
    bit for bit).  Its untied head, drawn at 1/sqrt(d), gives logits up to
    3.4, seven times the tied qwen3 case's ~0.5, and a bf16 rounding that
    lands elsewhere moves a logit by a step of 2^-8 of that scale; so atol
    0.1, the same share of the logits' scale as that test's 2e-2 (measured
    0.058 at the 30th position)."""
    jcfg, tcfg = _cfgs("internvl2-26b", dtype="bfloat16",
                       attn_impl="pallas")
    jp, tp = _ref_params(jcfg, seed=7)
    assert tp["patch_proj"].dtype == torch.bfloat16
    stubs = _stubs(jcfg, seed=20)
    x, _, _ = tlm._embed_inputs(tp, {"tokens": np.zeros((2, 1), np.int32),
                                     **stubs}, tcfg, torch.device("cpu"))
    jx, _, _ = jlm._embed_inputs(jp, {"tokens": jnp.zeros((2, 1), jnp.int32),
                                      "patch_embed": jnp.asarray(
                                          stubs["patch_embed"])}, jcfg)
    np.testing.assert_array_equal(_np(x), _np(jx))
    out = _serve_both(jcfg, tcfg, jp, tp, _tokens(jcfg, seed=16), 12, stubs)
    np.testing.assert_allclose(_np(out["tf"]), _np(out["jf"]),
                               rtol=0, atol=0.1)
    for jl, tl in zip(out["jsteps"], out["tsteps"]):
        np.testing.assert_allclose(_np(tl[:, :tcfg.vocab_size]),
                                   _np(jl[:, :tcfg.vocab_size]),
                                   rtol=0, atol=0.1)


def test_chunked_serve_path_matches_reference():
    jcfg, tcfg = _cfgs("qwen3-0.6b", attn_impl="chunked", attn_q_chunk=8)
    jp, tp = _ref_params(jcfg, seed=1)
    out = _serve_both(jcfg, tcfg, jp, tp, _tokens(jcfg, seed=8), 11)
    np.testing.assert_allclose(_np(out["tf"]), _np(out["jf"]), **TOL)
    for jl, tl in zip(out["jsteps"], out["tsteps"]):
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_gelu_and_bias_blocks_match_reference():
    """The dense blocks' GELU MLP and biases (whisper's) on a
    qwen3-shaped stack."""
    jcfg, tcfg = _cfgs("qwen3-0.6b", mlp_act="gelu", use_bias=True,
                       qk_norm=False)
    jp, tp = _ref_params(jcfg, seed=2)
    out = _serve_both(jcfg, tcfg, jp, tp, _tokens(jcfg, seed=9), 12)
    np.testing.assert_allclose(_np(out["tf"]), _np(out["jf"]), **TOL)
    for jl, tl in zip(out["jsteps"], out["tsteps"]):
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_bf16_serve_path_matches_reference():
    """The serve path's dtype: bf16 weights and activations, f32 norm
    scales and logits."""
    jcfg, tcfg = _cfgs("qwen3-0.6b", dtype="bfloat16", attn_impl="pallas")
    jp, tp = _ref_params(jcfg, seed=3)
    assert tp["stack"]["p0"]["wq"].dtype == torch.bfloat16
    assert tp["stack"]["p0"]["attn_norm"].dtype == torch.float32
    out = _serve_both(jcfg, tcfg, jp, tp, _tokens(jcfg, seed=10), 12)
    assert out["tf"].dtype == torch.float32
    np.testing.assert_allclose(_np(out["tf"]), _np(out["jf"]),
                               rtol=0, atol=2e-2)
    for jl, tl in zip(out["jsteps"], out["tsteps"]):
        np.testing.assert_allclose(_np(tl[:, :tcfg.vocab_size]),
                                   _np(jl[:, :tcfg.vocab_size]),
                                   rtol=0, atol=2e-2)


@pytest.mark.parametrize("impl", ["dense", "chunked", "pallas"])
def test_prefill_then_decode_equals_forward(impl):
    """Inside the port: prefill + 2 decode steps == teacher-forced
    forward (tests/test_archs.py:75 for the port)."""
    cfg = replace(tconfigs.get_arch("qwen3-0.6b").reduced(), attn_impl=impl,
                  attn_q_chunk=8)
    params = tlm.init_params(0, cfg, device="cpu")
    toks = _tokens(cfg, s=14, seed=11)
    full = tlm.forward(params, {"tokens": toks}, cfg, device="cpu")
    lg, cache = tlm.prefill(params, {"tokens": toks[:, :12]}, cfg,
                            max_len=16, device="cpu")
    np.testing.assert_allclose(_np(lg[:, :cfg.vocab_size]), _np(full[:, 11]),
                               **TOL)
    for i in range(2):
        lg, cache2 = tlm.decode_step(params, cache, toks[:, 12 + i:13 + i],
                                     12 + i, cfg, device="cpu")
        assert cache2 is cache                    # updated in place
        np.testing.assert_allclose(_np(lg[:, :cfg.vocab_size]),
                                   _np(full[:, 12 + i]), **TOL)
    assert bool((lg[:, cfg.vocab_size:] == -1e30).all())


def test_ragged_prompt_through_the_kernel_path():
    """A prompt whose length is no multiple of the reference's kv block:
    the pallas route equals the dense one (f32)."""
    cfg = tconfigs.get_arch("qwen3-0.6b").reduced()
    params = tlm.init_params(1, cfg, device="cpu")
    toks = _tokens(cfg, s=100, seed=12)
    got, _ = tlm.prefill(params, {"tokens": toks},
                         replace(cfg, attn_impl="pallas"), device="cpu")
    want, _ = tlm.prefill(params, {"tokens": toks}, cfg, device="cpu")
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# -- weights and devices ------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_numpy_round_trip_is_exact(dtype):
    jcfg, _ = _cfgs("minitron-4b", dtype=dtype)
    p_np = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(4), jcfg))
    tp = tmodels.lm_params_from_numpy(p_np, device="cpu")
    assert tp["embed"].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(tp["embed"]),
                                  p_np["embed"].astype(np.float32))
    back = tmodels.lm_params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p_np)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_init_params_seeded_with_the_reference_layout():
    jcfg, tcfg = _cfgs("internlm2-1.8b", dtype="bfloat16")
    a = tlm.init_params(3, tcfg, device="cpu")
    b = tlm.init_params(3, tcfg, device="cpu")
    c = tlm.init_params(4, tcfg, device="cpu")
    ref = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                         jax.random.key(0))
    flat_a = jax.tree_util.tree_leaves_with_path(ref)
    for path, leaf in flat_a:
        t = a
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == leaf.dtype.name
    assert all(torch.equal(x, y) for x, y in zip(tlm._leaves(a),
                                                 tlm._leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
    assert float(a["embed"].float().abs().max()) <= 2 * 0.02 + 1e-3
    assert bool((a["stack"]["p0"]["attn_norm"] == 1).all())


@pytest.mark.parametrize("name", FRONTEND)
def test_frontend_init_params_have_the_reference_layout(name):
    """The port's own draw: the reference's tree, shapes and dtypes; norm
    scales 1; the learned positions at scale 0.02; the encoder's blocks
    without cross-attention, the decoder's with it (whisper)."""
    jcfg, tcfg = _cfgs(name, dtype="bfloat16")
    p = tlm.init_params(3, tcfg, device="cpu")
    ref = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                         jax.random.key(0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        t = p
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == leaf.dtype.name
    assert tlm.param_count(p) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(ref))
    for leaf in [p.get("pos_embed"), p.get("enc", {}).get("pos_embed")]:
        if leaf is not None:
            assert 0 < float(leaf.float().abs().max()) <= 2 * 0.02 + 1e-3
    if tcfg.enc_layers:
        assert bool((p["enc"]["final_norm"] == 1).all())
        assert "xwq" not in p["enc"]["stack"]["p0"]
        assert bool((p["stack"]["p0"]["xattn_norm"] == 1).all())
        assert p["stack"]["p0"]["xbk"].shape == (tcfg.n_layers,
                                                 tcfg.n_kv_heads * 16)
    else:
        assert p["patch_proj"].shape == (32, tcfg.d_model)


def test_moe_dispatch_hook_still_raises():
    """The MoE layers call ``moe_dispatch`` where it is set, so a hook that
    raises raises from the model; nothing is refused: a config carrying
    the ``act_shard_moe`` split (as the plan sets it on a mesh) builds and
    runs on a one-rank mesh, its logits bitwise those without it."""
    from repro_torch.distributed.sharding import ExpertSplit
    from repro_torch.launch import plan as tplan
    from repro_torch.launch.mesh import make_mesh

    def hook(*a, **k):
        raise NotImplementedError("moe_dispatch reached")

    base = replace(tconfigs.get_arch("granite-moe-3b-a800m").reduced(),
                   moe_impl="scatter")
    cfg = replace(base, moe_dispatch=hook)
    params = tlm.init_params(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="moe_dispatch reached"):
        tlm.forward(params, {"tokens": np.zeros((1, 4), np.int32)}, cfg,
                    device="cpu")
    mesh = make_mesh((1, 1), ("data", "model"), backend="meta",
                     device="cpu")
    split = replace(base, act_shard_moe=ExpertSplit(mesh))
    params = tlm.init_params(0, split, device="cpu")
    plan = tplan.make_plan(split, "prefill_32k", mesh)
    assert isinstance(plan.cfg.act_shard_moe, ExpertSplit)
    specs = tplan.sharding_specs(plan, mesh)
    toks = {"tokens": _tokens(base)}
    want = tlm.forward(params, toks, base, device="cpu")
    got = tlm.forward(params, toks, split, device="cpu", mesh=mesh,
                      specs={k: specs[k] for k in ("params", "act",
                                                   "logits")})
    assert torch.equal(got, want)


def test_entry_points_run_on_the_card_by_default():
    """Without ``device="cpu"`` the LM entry points and the task-model
    factories ask for CUDA, and raise where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = tconfigs.get_arch("qwen3-0.6b").reduced()
    params = tlm.init_params(0, cfg, device="cpu")
    toks = np.zeros((1, 4), np.int32)
    from repro_torch.models import papertasks
    calls = [lambda: tlm.init_params(0, cfg),
             lambda: tlm.init_cache(cfg, 1, 8),
             lambda: tlm.forward(params, {"tokens": toks}, cfg),
             lambda: tlm.prefill(params, {"tokens": toks}, cfg),
             lambda: tlm.decode_step(params, {}, toks[:, :1], 0, cfg),
             lambda: tmodels.lm_params_from_numpy({"w": np.zeros(2)}),
             lambda: papertasks.make_task_model("sr", 0),
             lambda: papertasks.params_from_numpy({"w": np.zeros(2)})]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_params_on_another_device_are_refused():
    cfg = tconfigs.get_arch("qwen3-0.6b").reduced()
    params = tlm.init_params(0, cfg, device="cpu")
    params["final_norm"] = params["final_norm"].to("meta")
    with pytest.raises(ValueError, match="params are on meta"):
        tlm.forward(params, {"tokens": np.zeros((1, 4), np.int32)}, cfg,
                    device="cpu")


def test_norm_kernel_route_counts_no_launch_on_cpu():
    """impl="pallas" on CPU tensors takes the plain versions (K3, K4)."""
    tops.reset_launch_counts()
    cfg = replace(tconfigs.get_arch("qwen3-0.6b").reduced(),
                  attn_impl="pallas")
    params = tlm.init_params(0, cfg, device="cpu")
    tlm.prefill(params, {"tokens": _tokens(cfg)}, cfg, device="cpu")
    tlayers.rms_norm(torch.ones(2, 8), torch.ones(8), impl="pallas")
    assert tops.launch_counts() == {"fedavg_accum": 0, "dequant_merge": 0,
                                    "rmsnorm": 0, "flash_attention": 0,
                                    "ssd": 0}
