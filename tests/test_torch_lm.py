"""The port's LM serve path — configs, layers, ``forward``/``prefill``/
``decode_step`` — against the JAX reference on the CPU.

Inputs are made with numpy from a seed and given to both packages; the
reference's weights (``jax.random`` init) are carried across with
``lm_params_from_numpy``.  The reduced configs (``ArchConfig.reduced()``:
f32, 4 layers, d_model 64, head_dim 16, vocab 256) of the four dense
archs.  Tolerances, and why:

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
UNPORTED = {"internvl2-26b": "frontend", "whisper-base": "frontend"}
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


@pytest.mark.parametrize("name", DENSE + MOE)
def test_block_shapes_match_at_published_widths(name):
    """The full config's parameter shapes, without allocating them."""
    j, t = jconfigs.get_arch(name), tconfigs.get_arch(name)
    for jk, tk in zip(jlm.layer_plan(j), tlm.layer_plan(t)):
        assert tlm._block_shapes(t, tk) == jlm._block_shapes(j, jk)


# -- layers -------------------------------------------------------------------
@pytest.mark.parametrize("theta,hd,n,atol", [(10_000.0, 16, 40, 2e-5),
                                             (1_000_000.0, 128, 2064, 2e-4)])
def test_rope_matches_reference(theta, hd, n, atol):
    """Angles up to 2,063 rad at the serve path's lengths: one f32 ulp of
    such an angle is 2.4e-4 rad, and the libraries' exp, cos and sin differ
    in the last bits, so the long case allows 2e-4 (measured 6.8e-5)."""
    rng = _rng(1)
    x = _normal(rng, (2, n, 3, hd))
    pos = np.arange(n)[None, :]
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
    got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos),
                       theta=theta)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=atol)
    # per-token positions (decode) broadcast the same way
    posb = np.full((2, 1), n - 1)
    want = jlayers.rope(jnp.asarray(x[:, -1:]), jnp.asarray(posb),
                        theta=theta)
    got = tlayers.rope(torch.from_numpy(x[:, -1:]), torch.from_numpy(posb),
                       theta=theta)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=atol)


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


# -- the model ----------------------------------------------------------------
def _tokens(cfg, b=2, s=14, seed=7):
    return _rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _serve_both(jcfg, tcfg, jp, tp, toks, s):
    """forward over all of ``toks``; prefill over the first ``s`` tokens,
    then decode the rest one by one — in both packages."""
    out = {}
    out["jf"] = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    out["tf"] = tlm.forward(tp, {"tokens": toks}, tcfg, device="cpu")
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jcfg,
                         max_len=s + 4)
    tl, tc = tlm.prefill(tp, {"tokens": toks[:, :s]}, tcfg, max_len=s + 4,
                         device="cpu")
    out["jsteps"], out["tsteps"] = [jl], [tl]
    for i in range(toks.shape[1] - s):
        step = toks[:, s + i:s + i + 1]
        jl, jc = jlm.decode_step(jp, jc, jnp.asarray(step), jnp.int32(s + i),
                                 jcfg)
        tl, tc = tlm.decode_step(tp, tc, step, s + i, tcfg, device="cpu")
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


def test_chunked_serve_path_matches_reference():
    jcfg, tcfg = _cfgs("qwen3-0.6b", attn_impl="chunked", attn_q_chunk=8)
    jp, tp = _ref_params(jcfg, seed=1)
    out = _serve_both(jcfg, tcfg, jp, tp, _tokens(jcfg, seed=8), 11)
    np.testing.assert_allclose(_np(out["tf"]), _np(out["jf"]), **TOL)
    for jl, tl in zip(out["jsteps"], out["tsteps"]):
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


def test_gelu_and_bias_blocks_match_reference():
    """The dense blocks' GELU MLP and biases (whisper's, whose encoder is
    not ported) on a qwen3-shaped stack."""
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


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_families_raise(name):
    cfg = tconfigs.get_arch(name).reduced()
    toks = np.zeros((1, 4), np.int32)
    calls = [lambda: tlm.init_params(0, cfg, device="cpu"),
             lambda: tlm.init_cache(cfg, 1, 8, device="cpu"),
             lambda: tlm.forward({}, {"tokens": toks}, cfg, device="cpu"),
             lambda: tlm.prefill({}, {"tokens": toks}, cfg, device="cpu"),
             lambda: tlm.decode_step({}, {}, toks[:, :1], 0, cfg,
                                     device="cpu")]
    for call in calls:
        with pytest.raises(NotImplementedError, match=UNPORTED[name]):
            call()


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
