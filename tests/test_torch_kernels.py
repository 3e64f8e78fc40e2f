"""K1 (the Eq. 1 fold), K3 (RMSNorm) and K4 (flash attention) of the
PyTorch port against the JAX reference.

On the CPU the port's wrappers take the plain versions.  K1's must match
``repro.kernels.ref.fedavg_accum_ref`` bitwise in f32 and the Pallas kernel
(interpret mode, as ``tests/test_kernels.py`` runs it) to rtol 1e-6.  K3's
and K4's are held to ``repro.kernels.ref`` and to the Pallas kernels in
interpret mode over the reference's sweeps at ``tests/test_kernels.py``'s
tolerances: 2e-5 in f32, 2e-2 in bf16.  The CUDA kernels themselves are
held against the plain versions on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from _torch_devices import Elsewhere  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import fedavg_accum as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SHAPES = [(7,), (33,), (300, 5), (129, 1025), (2, 3, 5, 7), (4096,)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
EDGES = [(0.0, 0.0), (0.0, 4.0), (7.0, 0.0)]


def _pair(shape, dtype, seed):
    """The same values in both frameworks (f32 numpy, rounded to dtype)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape, dtype=np.float32)
    t = rng.standard_normal(shape, dtype=np.float32)
    jd, td = DTYPES[dtype]
    return ((jnp.asarray(a, jd), jnp.asarray(t, jd)),
            (torch.from_numpy(a).to(td), torch.from_numpy(t).to(td)))


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_reference_oracle(shape, dtype):
    (ja, jt), (ta, tt) = _pair(shape, dtype, 1)
    want = jref.fedavg_accum_ref(ja, jt, 10.0, 3.0)
    got = tops.fedavg_accum(ta, tt, 10.0, 3.0)      # CPU -> plain version
    assert got.shape == shape and got.dtype == DTYPES[dtype][1]
    if dtype == "f32":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_kernel_interpret(shape, dtype):
    (ja, jt), (ta, tt) = _pair(shape, dtype, 2)
    want = jops.fedavg_accum(ja, jt, 10.0, 3.0)
    got = tops.fedavg_accum(ta, tt, 10.0, 3.0)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "f32" \
        else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("n_old,n_k", EDGES)
def test_weight_edges(n_old, n_k):
    (ja, _), (ta, _) = _pair((50,), "f32", 3)
    jt, tt = ja * 3.0 + 1.0, ta * 3.0 + 1.0
    got = tops.fedavg_accum(ta, tt, n_old, n_k)
    np.testing.assert_array_equal(
        _np(got), _np(jref.fedavg_accum_ref(ja, jt, n_old, n_k)))
    np.testing.assert_allclose(
        _np(got), _np(jops.fedavg_accum(ja, jt, n_old, n_k)),
        rtol=1e-6, atol=1e-6)
    if n_old + n_k == 0:
        np.testing.assert_array_equal(_np(got), _np(ta))   # acc unchanged


def test_large_leaf_bitwise():
    (ja, jt), (ta, tt) = _pair((512, 512), "f32", 4)
    np.testing.assert_array_equal(
        _np(tops.fedavg_accum(ta, tt, 37.0, 11.0)),
        _np(jref.fedavg_accum_ref(ja, jt, 37.0, 11.0)))


def test_lane_weights_fold_each_lane_on_its_own():
    """[L] weights on a lane-stacked leaf = one scalar call per lane."""
    rng = np.random.default_rng(5)
    acc = torch.from_numpy(rng.standard_normal((4, 6, 5), dtype=np.float32))
    theta = torch.from_numpy(rng.standard_normal((4, 6, 5), dtype=np.float32))
    n_old = torch.tensor([0.0, 3.0, 7.0, 0.0])
    n_k = torch.tensor([0.0, 0.0, 5.0, 2.0])
    got = tops.fedavg_accum(acc, theta, n_old, n_k)
    for lane in range(4):
        want = tref.fedavg_accum_ref(acc[lane], theta[lane],
                                     float(n_old[lane]), float(n_k[lane]))
        assert torch.equal(got[lane], want)


def test_kernel_entry_refuses_cpu_tensors():
    """No silent fallback below the wrapper: the launcher takes CUDA only."""
    acc = torch.zeros(2, 8)
    w = torch.zeros(2)
    tops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        tfa.fedavg_accum_lanes(acc, acc, w, w)
    tops.fedavg_accum(acc, acc, w, w)                # plain version
    assert tops.launch_counts() == {"fedavg_accum": 0, "dequant_merge": 0,
                                    "rmsnorm": 0, "flash_attention": 0,
                                    "ssd": 0}


def test_wrapper_refuses_other_devices():
    acc = Elsewhere(8)
    with pytest.raises(ValueError, match="no fedavg_accum kernel"):
        tops.fedavg_accum(acc, acc, 1.0, 1.0)


# -- K3 (RMSNorm) -------------------------------------------------------------
RMS_SHAPES = [(4, 64), (2, 3, 128), (5, 256), (1, 512)]
ATTN_SWEEP = [(2, 128, 4, 2, 32, 64, 64), (1, 100, 8, 8, 16, 64, 64),
              (2, 260, 6, 2, 64, 128, 128), (1, 512, 2, 1, 128, 256, 256)]
KERNEL_TOL = {"f32": dict(rtol=2e-5, atol=2e-5),
              "bf16": dict(rtol=2e-2, atol=2e-2)}


def _same(shape, dtype, seed):
    """One f32 numpy draw, rounded to ``dtype`` in both frameworks."""
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_plain_matches_reference(shape, dtype):
    jx, tx = _same(shape, dtype, 10)
    js, ts = _same(shape[-1:], "f32", 11)
    got = tops.rmsnorm(tx, ts)                       # CPU -> plain version
    assert got.shape == shape and got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(jref.rmsnorm_ref(jx, js)),
                               **KERNEL_TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(jops.rmsnorm(jx, js)),
                               **KERNEL_TOL[dtype])


@pytest.mark.parametrize("which", ["x", "out", "scale"])
@pytest.mark.parametrize("offset", [0, 4, 8, 12])
def test_rmsnorm_vector_paths_need_all_three_aligned(which, offset):
    """K3's vector and register paths run only where x, out and the scale
    all start on a 16-byte boundary (the register path reads the scale as
    float4s); a row that is no whole number of vectors never takes them."""
    from repro_torch.kernels import rmsnorm as trn
    d = 32

    def at(k):
        """A [d] f32 view whose base is k bytes past a 16-byte boundary."""
        base = torch.zeros(d + 4)
        skip = (k - base.data_ptr()) % 16 // 4
        return base[skip:skip + d]

    views = {name: at(offset if name == which else 0)
             for name in ("x", "out", "scale")}
    assert views[which].data_ptr() % 16 == offset
    x, out = views["x"].view(1, d), views["out"].view(1, d)
    assert trn.vector_ok(x, out, views["scale"]) == (offset == 0)
    assert not trn.vector_ok(x[:, :30], out[:, :30], views["scale"][:30])


# -- K4 (flash attention) -----------------------------------------------------
def _qkv(b, s, hq, hkv, d, dtype, seed, t=None):
    t = s if t is None else t
    return [_same(shape, dtype, seed + i) for i, shape in enumerate(
        [(b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d)])]


@pytest.mark.parametrize("b,s,hq,hkv,d,bq,bk", ATTN_SWEEP)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_plain_matches_reference(b, s, hq, hkv, d, bq, bk,
                                                 dtype):
    """The reference's sweep (GQA groups 1-3, ragged lengths, head dims
    16-128) against its oracle and its Pallas kernel in interpret mode."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(b, s, hq, hkv, d, dtype, 20)
    got = tops.flash_attention(tq, tk, tv, causal=True)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    oracle = jnp.moveaxis(jref.attention_ref(
        *(jnp.moveaxis(x, 2, 1) for x in (jq, jk, jv)), causal=True), 1, 2)
    np.testing.assert_allclose(_np(got), _np(oracle), **KERNEL_TOL[dtype])
    pallas = jops.flash_attention(jq, jk, jv, causal=True, block_q=bq,
                                  block_k=bk)
    np.testing.assert_allclose(_np(got), _np(pallas), **KERNEL_TOL[dtype])


@pytest.mark.parametrize("s,t,causal", [(300, 200, True), (256, 256, False),
                                        (64, 200, True)])
def test_flash_attention_padding_semantics_match_pallas(s, t, causal):
    """Queries and keys of other lengths: the reference wrapper pads keys
    with zeros to its block, which a causal query at or past ``t`` sees;
    non-causal attention over a block multiple needs no padding."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, s, 4, 2, 64, "f32", 30, t=t)
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    want = jops.flash_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **KERNEL_TOL["f32"])


def test_flash_attention_noncausal_padding_raises_like_the_reference():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 100, 2, 1, 16, "f32", 40)
    with pytest.raises(NotImplementedError, match="non-causal padding"):
        jops.flash_attention(jq, jk, jv, causal=False)
    with pytest.raises(NotImplementedError, match="non-causal padding"):
        tops.flash_attention(tq, tk, tv, causal=False)


def test_flash_matches_model_layer():
    """The kernel route is a drop-in for the model's dense attention
    (``tests/test_kernels.py::test_flash_matches_model_layer``)."""
    from repro_torch.models.layers import gqa_attention
    (_, q), (_, k), (_, v) = _qkv(2, 128, 4, 2, 32, "f32", 50)
    np.testing.assert_allclose(
        _np(gqa_attention(q, k, v, causal=True, impl="pallas")),
        _np(gqa_attention(q, k, v, causal=True, impl="dense")),
        rtol=3e-5, atol=3e-5)


def test_new_kernel_entries_refuse_cpu_tensors():
    from repro_torch.kernels import flash_attention as tfl
    from repro_torch.kernels import rmsnorm as trn
    x = torch.zeros(2, 1, 4, 16)
    with pytest.raises(ValueError, match="CUDA"):
        trn.rmsnorm_rows(x.reshape(8, 16), torch.ones(16), 1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        tfl.flash_attention_bshd(x, x, x, causal=True, t_pad=1)
    with pytest.raises(ValueError, match="no rmsnorm kernel"):
        tops.rmsnorm(Elsewhere(2, 8), Elsewhere(8))


# -- K4's wgmma route: its numerics in its tile order ---------------------------
def _wgmma_route_emulation(q, k, v, *, causal, t_pad):
    """The bf16 wgmma kernel's arithmetic, step by step, on the CPU: q tiles
    of 128 rows, keys in steps of 64 up to the q tile's causal end (zero
    keys up to ``t_pad``); S in f32 from the bf16 operands; the online
    softmax in f32 on scores scaled by log2(e)/sqrt(d), masked at -1e30,
    ``l`` summed from the f32 ``p``; ``p`` rounded to bf16 before P·V,
    accumulated in f32; the output divided by ``l`` (where ``l > 0``) and
    rounded to bf16."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)                                # [b,hq,s,d]
    kf, vf = (torch.nn.functional.pad(
        x.float().transpose(1, 2), (0, 0, 0, t_pad - t)).repeat_interleave(
            hq // hkv, dim=1) for x in (k, v))                    # [b,hq,tp,d]
    scale = math.log2(math.e) / math.sqrt(d)
    neg = -1e30
    out = torch.empty(b, hq, s, d)
    for q0 in range(0, s, 128):
        rows = torch.arange(q0, min(q0 + 128, s))
        m = torch.full((b, hq, len(rows)), neg)
        l = torch.zeros(b, hq, len(rows))
        o = torch.zeros(b, hq, len(rows), d)
        k_end = min(q0 + 128, t_pad) if causal else t_pad
        for k0 in range(0, -(-k_end // 128) * 128, 64):
            keys = torch.arange(k0, k0 + 64)
            x = (qf[:, :, rows] @ torch.nn.functional.pad(
                kf[:, :, k0:k0 + 64], (0, 0, 0, max(0, k0 + 64 - t_pad)))
                .transpose(-1, -2)) * scale
            bad = keys[None, :] >= t_pad
            if causal:
                bad = bad | (keys[None, :] > rows[:, None])
            x = x.masked_fill(bad, neg)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.where(x <= neg, 0.0, torch.exp2(x - m_new[..., None]))
            l = l * alpha + p.sum(-1)
            vt = torch.nn.functional.pad(vf[:, :, k0:k0 + 64],
                                         (0, 0, 0, max(0, k0 + 64 - t_pad)))
            o = o * alpha[..., None] + p.bfloat16().float() @ vt
            m = m_new
        out[:, :, rows] = o / torch.where(l > 0, l, 1.0)[..., None]
    return out.transpose(1, 2).bfloat16()


# bf16 cases the wgmma route takes (d 64 and 128): the reference's sweep at
# those dims, GQA groups 1, 2 and 8, ragged s with t < s, non-causal.
WGMMA_CASES = [((2, 260, 6, 2, 64), 260, True), ((1, 512, 2, 1, 128), 512, True),
               ((1, 300, 4, 2, 64), 200, True), ((1, 100, 8, 8, 128), 100, True),
               ((1, 160, 8, 1, 64), 160, True), ((2, 256, 4, 2, 64), 256, False)]


@pytest.mark.parametrize("shape,t,causal", WGMMA_CASES)
def test_wgmma_route_numerics_match_reference(shape, t, causal):
    """Rounding P to bf16 before P·V (new against the Pallas kernel, which
    multiplies f32 p by v; the reference's dense and chunked attention round
    P to the input type too) keeps the route within the reference's bf16
    tolerance of its oracle and of its Pallas kernel in interpret mode."""
    b, s, hq, hkv, d = shape
    (jq, tq), (jk, tk), (jv, tv) = _qkv(b, s, hq, hkv, d, "bf16", 60, t=t)
    got = _wgmma_route_emulation(tq, tk, tv, causal=causal,
                                 t_pad=tops.padded_kv_len(t))
    pallas = jops.flash_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(pallas), **KERNEL_TOL["bf16"])
    if t == s:
        oracle = jnp.moveaxis(jref.attention_ref(
            *(jnp.moveaxis(x, 2, 1) for x in (jq, jk, jv)), causal=causal),
            1, 2)
        np.testing.assert_allclose(_np(got), _np(oracle), **KERNEL_TOL["bf16"])


@pytest.mark.parametrize("s", [1000, 2048])
def test_wgmma_route_numerics_hold_the_serve_tolerance(s):
    """At the serve path's head width and lengths the outputs are ~0.03, and
    the card holds K4 to atol/rtol 8e-3 there (``SERVE_ATTN_BF16_TOL`` in
    chip_smoke.py): the bf16 P stays within it against the plain version."""
    (_, q), (_, k), (_, v) = _qkv(1, s, 2, 1, 128, "bf16", 70)
    tp = tops.padded_kv_len(s)
    got = _wgmma_route_emulation(q, k, v, causal=True, t_pad=tp)
    want = tref.flash_attention_bshd_ref(q, k, v, causal=True, t_pad=tp)
    np.testing.assert_allclose(_np(got), _np(want), rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_attention_route_by_dtype_and_head_dim(dtype, d):
    """bf16 at d 64 and 128 takes the wgmma kernel; f32 (wgmma would be
    TF32) and bf16 at d 16 and 32 the SIMT kernel."""
    from repro_torch.kernels import flash_attention as tfl
    want = "wgmma" if dtype == "bf16" and d in (64, 128) else "simt"
    assert tfl.route(DTYPES[dtype][1], d) == want


# (shape, dtype) -> (path, lanes per row, rows per warp, vectors a lane):
# the reference's sweep, the serve path's norms, and d 64 to 4096.
RMS_GEOMETRY = [
    ((4, 64), "f32", ("registers", 16, 2, 1)),
    ((2, 3, 128), "f32", ("registers", 32, 1, 1)),
    ((5, 256), "f32", ("registers", 32, 1, 2)),
    ((1, 512), "f32", ("registers", 32, 1, 4)),
    ((4, 64), "bf16", ("registers", 8, 4, 1)),
    ((2, 3, 128), "bf16", ("registers", 16, 2, 1)),
    ((5, 256), "bf16", ("registers", 32, 1, 1)),
    ((1, 512), "bf16", ("registers", 32, 1, 2)),
    ((8192, 1024), "bf16", ("registers", 32, 1, 4)),
    ((131072, 128), "bf16", ("registers", 16, 2, 1)),
    ((3, 1024), "f32", ("loop", 32, 1, 0)),
    ((3, 4096), "bf16", ("loop", 32, 1, 0)),
    ((3, 4096), "f32", ("loop", 32, 1, 0)),
]


@pytest.mark.parametrize("shape,dtype,want", RMS_GEOMETRY)
def test_rmsnorm_launch_geometry(shape, dtype, want):
    """K3 holds a row in registers over min(32, next_pow2(vectors)) lanes,
    so short rows share a warp; long rows keep a warp each."""
    from repro_torch.kernels import rmsnorm as trn
    itemsize = 4 if dtype == "f32" else 2
    g = trn.geometry(shape[-1], itemsize, True)
    assert (g["path"], g["lanes_per_row"], g["rows_per_warp"],
            g["vectors_per_lane"]) == want
    if g["path"] == "registers":
        per_lane = 16 // itemsize * g["vectors_per_lane"]
        assert per_lane * g["lanes_per_row"] >= shape[-1]
    assert trn.geometry(37, itemsize, False)["path"] == "elements"
