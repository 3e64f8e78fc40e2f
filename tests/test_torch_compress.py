"""The port's compressed combine against the JAX reference: K2's plain
version, int8 quantization, top-k, the wire-format byte count and error
feedback, on the same numpy inputs.

Tolerances: K2's plain version does the reference oracle's f32 ops in its
order (bitwise); the Pallas kernel in interpret mode runs through XLA,
which may contract multiplies and adds (rtol 2e-5, the reference's own
``tests/test_kernels.py`` bound).  ``int8_quantize`` is bitwise.  Top-k
may order equal magnitudes differently from ``jax.lax.top_k``, so it is
held on the decoded dense update and the residual (bitwise), never on the
index order.  The CUDA kernel is held against the plain version on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import compress as jcomp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import compress as tcomp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.layout import FlatLayout, FlatTree  # noqa: E402

SHAPES = [(7,), (33,), (300, 5), (129, 1025), (2, 3, 5, 7), (4096,)]
EDGES = [(0.0, 0.0), (0.0, 4.0), (7.0, 0.0), (10.0, 3.0)]
TREE = {"w": (6, 5), "b": (7,), "e": (33,)}


def _payload(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.integers(-128, 128, shape).astype(np.int8),
            rng.standard_normal(shape, dtype=np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in TREE.items()}


# -- K2's plain version -------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_old,n_k", EDGES)
def test_dequant_merge_plain_matches_reference_oracle(shape, n_old, n_k):
    a, q, g = _payload(shape, 1)
    want = jref.dequant_merge_ref(jnp.asarray(a), jnp.asarray(q),
                                  jnp.asarray(g), 0.013, n_old, n_k)
    got = tops.dequant_merge(*_t(a, q, g), 0.013, n_old, n_k)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if n_old + n_k == 0.0:
        np.testing.assert_array_equal(got.numpy(), a)


@pytest.mark.parametrize("shape", SHAPES)
def test_dequant_merge_plain_matches_pallas_kernel_interpret(shape):
    a, q, g = _payload(shape, 2)
    want = jops.dequant_merge(jnp.asarray(a), jnp.asarray(q), jnp.asarray(g),
                              0.013, 10.0, 3.0)
    got = tops.dequant_merge(*_t(a, q, g), 0.013, 10.0, 3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_dequant_merge_fused_equals_unfused():
    """Dequantize-then-K1 composed equals the fused fold: bitwise for the
    plain versions, rtol 2e-5 against the reference's fused kernel."""
    a, q, g = _payload((513,), 3)
    ta, tq, tg = _t(a, q, g)
    theta = tg + tq.float() * torch.tensor(0.021)
    unfused = tops.fedavg_accum(ta, theta, 6.0, 2.0)
    fused = tops.dequant_merge(ta, tq, tg, 0.021, 6.0, 2.0)
    assert torch.equal(fused, unfused)
    want = jops.dequant_merge(jnp.asarray(a), jnp.asarray(q), jnp.asarray(g),
                              0.021, 6.0, 2.0)
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_dequant_merge_flat_is_the_per_leaf_fold():
    """One fold over a flat multi-leaf buffer (K2's layout, ragged leaves
    of 7, 33 and 30 elements) equals the reference oracle leaf by leaf."""
    rng = np.random.default_rng(4)
    layout = FlatLayout({k: torch.zeros(s) for k, s in TREE.items()})
    a, q, g = _payload((layout.n,), 5)
    scales = rng.uniform(0.001, 0.05, len(layout.names)).astype(np.float32)
    got = tops.dequant_merge_flat(*_t(a, q, g, scales), layout.offsets,
                                  torch.tensor(3.0), torch.tensor(5.0))
    for i, (off, size) in enumerate(zip(layout.offsets, layout.sizes)):
        sl = slice(off, off + size)
        want = jref.dequant_merge_ref(jnp.asarray(a[sl]), jnp.asarray(q[sl]),
                                      jnp.asarray(g[sl]), scales[i], 3.0, 5.0)
        np.testing.assert_array_equal(got[sl].numpy(), np.asarray(want))


def _tensors_in(obj, seen=None):
    """Every tensor reachable from ``obj``'s attributes, dicts and
    sequences."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        items = list(obj)
    elif hasattr(obj, "__dict__"):
        items = list(vars(obj).values())
    else:
        return []
    return [t for x in items for t in _tensors_in(x, seen)]


@pytest.mark.parametrize("lead", [(), (3,)])
def test_per_element_repeats_each_leaf_value_and_keeps_no_buffer(lead):
    """``per_element`` is ``repeat_interleave`` over the leaf sizes, and the
    layout keeps nothing of it: a per-element buffer cached between rounds
    would hold 4 bytes a parameter on the device (2.38 GB for
    qwen3-0.6b's f32 twin)."""
    layout = FlatLayout({k: torch.zeros(s) for k, s in TREE.items()})
    values = torch.randn(lead + (len(TREE),))
    got = layout.per_element(values)
    want = torch.repeat_interleave(values, torch.tensor(layout.sizes), dim=-1)
    assert got.shape == lead + (layout.n,) and torch.equal(got, want)
    assert all(t.numel() < layout.n for t in _tensors_in(layout))


def test_plain_path_counts_no_launch():
    tops.reset_launch_counts()
    tops.dequant_merge(*_t(*_payload((9,), 6)), 0.1, 1.0, 1.0)
    assert tops.launch_counts() == {"fedavg_accum": 0, "dequant_merge": 0,
                                    "rmsnorm": 0, "flash_attention": 0,
                                    "ssd": 0}


# -- int8 and top-k -----------------------------------------------------------
@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_int8_quantize_is_bitwise_the_reference(scale):
    tree = _tree(7, scale)
    tree["z"] = np.zeros((4,), np.float32)          # the 1e-12 floor
    jq, js = jcomp.int8_quantize({k: jnp.asarray(v) for k, v in tree.items()})
    tq, ts = tcomp.int8_quantize({k: torch.from_numpy(v)
                                  for k, v in tree.items()})
    assert isinstance(tq, FlatTree) and tq.flat.dtype == torch.int8
    for k in tree:
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
        assert float(ts[k]) == float(js[k]), k
    deq = tcomp.int8_dequantize(tq, ts)
    jdeq = jcomp.int8_dequantize(jq, js)
    for k in tree:
        np.testing.assert_array_equal(deq[k].numpy(), np.asarray(jdeq[k]))


def test_int8_rounds_half_to_even_like_jnp_round():
    x = np.asarray([127.0, -63.5, 62.5, 0.5, -0.5, 1.5, 2.5], np.float32)
    jq, _ = jcomp.int8_quantize({"x": jnp.asarray(x)})
    tq, _ = tcomp.int8_quantize({"x": torch.from_numpy(x)})
    np.testing.assert_array_equal(tq["x"].numpy(), np.asarray(jq["x"]))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5, 1.0])
def test_topk_matches_the_reference_on_dense_and_residual(frac):
    upd, err = _tree(8), _tree(9, 0.1)
    jpay, jst = jcomp.topk_compress(
        {k: jnp.asarray(v) for k, v in upd.items()},
        jcomp.TopKState({k: jnp.asarray(v) for k, v in err.items()}),
        frac=frac)
    tpay, tst = tcomp.topk_compress(
        {k: torch.from_numpy(v) for k, v in upd.items()},
        tcomp.TopKState({k: torch.from_numpy(v) for k, v in err.items()}),
        frac=frac)
    jdense = jcomp.topk_decompress(jpay, {k: jnp.asarray(v)
                                          for k, v in upd.items()})
    tdense = tcomp.topk_decompress(tpay, {k: torch.from_numpy(v)
                                          for k, v in upd.items()})
    for k in upd:
        assert tpay[k][0].dtype == torch.int32
        assert tpay[k][0].shape == (jcomp.topk_k(upd[k].size, frac),)
        np.testing.assert_array_equal(tdense[k].numpy(),
                                      np.asarray(jdense[k]))
        np.testing.assert_array_equal(tst.error[k].numpy(),
                                      np.asarray(jst.error[k]))


@pytest.mark.parametrize("size,frac", [(1, 0.01), (100, 0.29), (7, 1.0),
                                       (262144, 0.05), (17920, 0.05)])
def test_topk_k_matches(size, frac):
    assert tcomp.topk_k(size, frac) == jcomp.topk_k(size, frac)


@pytest.mark.parametrize("mode,frac", [("int8", 0.05), ("topk", 0.05),
                                       ("topk", 0.3)])
def test_payload_nbytes_matches_the_reference(mode, frac):
    sizes = {"stem": (64, 512), "w1_0": (512, 512), "head": (512, 35),
             "b": (7,)}
    jt = {k: jnp.zeros(s) for k, s in sizes.items()}
    tt = {k: torch.zeros(s) for k, s in sizes.items()}
    assert tcomp.payload_nbytes(tt, mode, frac) == \
        jcomp.payload_nbytes(jt, mode, frac)


def test_payload_nbytes_of_the_published_sr_model():
    from repro_torch.models.papertasks import make_task_model
    params, _ = make_task_model("sr", 0, device="cpu")
    assert tcomp.payload_nbytes(params, "int8") == 4_245_072


# -- encode and error feedback ------------------------------------------------
@pytest.mark.parametrize("mode", ["int8", "topk"])
@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 1.0), (2, 50.0)])
def test_error_feedback_conserves_the_update_exactly(mode, seed, scale):
    """sent + e_new == u bitwise, per leaf (the reference property)."""
    g, theta, res = _tree(seed, scale), _tree(seed + 10, scale), \
        _tree(seed + 20, scale * 0.1)
    tt = [{k: torch.from_numpy(v) for k, v in x.items()}
          for x in (g, theta, res)]
    payload, e_new = tcomp.make_encode_step(mode, 0.1)(*tt)
    u = {k: (theta[k] - g[k]) + res[k] for k in g}
    if mode == "int8":
        sent = tcomp.int8_dequantize(*payload)
    else:
        sent = tcomp.topk_decompress(payload, tt[0])
    for k in g:
        np.testing.assert_array_equal((sent[k] + e_new[k]).numpy(), u[k])


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_encode_step_matches_the_reference(mode):
    g, theta, res = _tree(3), _tree(4), _tree(5, 0.1)
    jpay, jres = jcomp.make_encode_step(mode, 0.1)(
        *[{k: jnp.asarray(v) for k, v in x.items()} for x in (g, theta, res)])
    tt = [{k: torch.from_numpy(v) for k, v in x.items()}
          for x in (g, theta, res)]
    tpay, tres = tcomp.make_encode_step(mode, 0.1)(*tt)
    for k in g:
        np.testing.assert_array_equal(tres[k].numpy(), np.asarray(jres[k]))
    if mode == "int8":
        for k in g:
            np.testing.assert_array_equal(tpay[0][k].numpy(),
                                          np.asarray(jpay[0][k]))
            assert float(tpay[1][k]) == float(jpay[1][k])


def test_compressor_residuals_commit_and_norm():
    like = {k: torch.zeros(s) for k, s in TREE.items()}
    comp = tcomp.CombineCompressor("int8", like)
    assert comp.payload_bytes == tcomp.payload_nbytes(like, "int8")
    assert all(float(v.abs().sum()) == 0.0 for v in comp.residual(0).values())
    r = {k: torch.full(s, 2.0) for k, s in TREE.items()}
    comp.commit({0: r, 3: r})
    n = sum(int(np.prod(s)) for s in TREE.values())
    assert comp.residual_norm() == pytest.approx(np.sqrt(2 * n * 4.0))
    with pytest.raises(ValueError, match="int8|topk"):
        tcomp.CombineCompressor("fp4", like)
