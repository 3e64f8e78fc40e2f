"""The port's Mamba-2 path — K5's plain version, ``models/ssd.py`` and the
``ssm`` family of the LM stack — against the JAX reference on the CPU.

Inputs are made with numpy from a seed and given to both packages; the
reference's weights (``jax.random`` init) are carried across with
``lm_params_from_numpy``.  On the CPU ``ops.ssd`` takes the plain chunk
loop (``ref.ssd_chunks_ref``); the reference's ``ops.ssd`` runs its Pallas
kernel in interpret mode.  Tolerances, and why:

* K5's function over ``tests/test_kernels.py``'s sweep: that file's
  2e-4 (f32) and 4e-2 (bf16), atol and rtol: the chunked and the
  token-recurrent forms sum over up to 128 rows in other orders (measured
  at most 7e-5 on outputs up to 33);
* the final state against ``ssd_chunked(return_state=True)``: the same
  2e-4;
* every function of ``models/ssd.py`` in f32: rtol 1e-5, atol 1e-5, the
  LM tests' tolerance (GEMM and reduction order, ``exp`` in the last bits);
* the reduced mamba2-2.7b (4 layers, d_model 64, 8 heads of 16, state 16)
  in f32: rtol 1e-5, atol 1e-5 on logits, caches and states; in bf16 atol
  2e-2 on logits (both round activations to bf16 at the same places; a
  sum in another order moves a value to the neighbouring bf16 number now
  and then);
* init rows: 1e-6 relative (``linspace``/``log`` may round differently).
"""

import math
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from _torch_devices import Elsewhere  # noqa: E402
from _torch_parity import one_intra_op_thread  # noqa: E402,F401
from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssd as jssd  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssd as tssd  # noqa: E402

ARCH = "mamba2-2.7b"
PUBLISHED_PARAMS = 2_702_624_256
TOL = dict(rtol=1e-5, atol=1e-5)
# tests/test_kernels.py:139-143: (b, s, h, p, g, n, chunk)
SWEEP = [(2, 64, 4, 16, 2, 32, 16), (1, 100, 8, 32, 1, 64, 32),
         (2, 128, 4, 64, 4, 16, 128)]
KTOL = {"float32": dict(rtol=2e-4, atol=2e-4),
        "bfloat16": dict(rtol=4e-2, atol=4e-2)}


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ssd_inputs(b, s, h, p, g, n, seed, dtype="float32"):
    """x, dt, A_log, B, C, D as numpy, shaped as tests/test_kernels.py's
    sweep draws them: dt = softplus(normal), B/C scaled by 0.5, A_log by
    0.3 and D by 0.1.  In bf16, x, dt, B and C are rounded to bf16 for both
    packages."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0).astype(np.float32)
    A_log = (rng.standard_normal(h) * 0.3).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.5).astype(np.float32)
    D = (rng.standard_normal(h) * 0.1).astype(np.float32)
    j = [jnp.asarray(a) for a in (x, dt, A_log, B, C, D)]
    t = [torch.from_numpy(a) for a in (x, dt, A_log, B, C, D)]
    if dtype == "bfloat16":
        for i in (0, 1, 3, 4):
            j[i] = j[i].astype(jnp.bfloat16)
            t[i] = t[i].to(torch.bfloat16)
    return j, t


def _bhsp(t):
    """Model layout -> the kernel's ``[b, h, s, ...]`` layout."""
    return t.transpose(1, 2).contiguous()


# -- K5's function ------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,ck", SWEEP)
def test_ssd_plain_matches_reference_kernel(b, s, h, p, g, n, ck, dtype):
    """The port's ops.ssd (the plain chunk loop) against the reference's
    ops.ssd (Pallas, interpret mode) and both oracles ``ssd_ref``."""
    j, t = _ssd_inputs(b, s, h, p, g, n, seed=s + ck, dtype=dtype)
    tops.reset_launch_counts()
    got = tops.ssd(*t, chunk=ck)
    assert tops.launch_counts()["ssd"] == 0         # CPU -> plain version
    assert got.shape == (b, s, h, p) and got.dtype == t[0].dtype
    want = jops.ssd(*j, chunk=ck)
    np.testing.assert_allclose(_np(got), _np(want), **KTOL[dtype])
    oracle = jref.ssd_ref(*(jnp.moveaxis(a, 2, 1) if a.ndim > 1 else a
                            for a in j))
    np.testing.assert_allclose(_np(got), _np(jnp.moveaxis(oracle, 1, 2)),
                               **KTOL[dtype])
    tor = tref.ssd_ref(*(_bhsp(a) if a.ndim > 1 else a for a in t))
    assert tor.dtype == t[0].dtype
    np.testing.assert_allclose(_np(tor.transpose(1, 2)),
                               _np(jnp.moveaxis(oracle, 1, 2)),
                               **KTOL[dtype])


@pytest.mark.parametrize("b,s,h,p,g,n,ck", SWEEP + [(1, 100, 8, 32, 1, 64,
                                                     128)])
def test_ssd_final_state_matches_reference_chunked(b, s, h, p, g, n, ck):
    """``return_state``: the carried state after the last row, against the
    reference's ``ssd_chunked(return_state=True)``; a ragged ``s`` (the
    tail padded with zero rows) leaves it as it was after row ``s - 1``."""
    j, t = _ssd_inputs(b, s, h, p, g, n, seed=3 * s + ck)
    y, state = tops.ssd(*t, chunk=ck, return_state=True)
    assert state.shape == (b, h, p, n) and state.dtype == torch.float32
    want_y, want_state = jssd.ssd_chunked(*j, chunk=ck, return_state=True)
    np.testing.assert_allclose(_np(state), _np(want_state), **KTOL["float32"])
    np.testing.assert_allclose(_np(y), _np(want_y), **KTOL["float32"])
    assert torch.equal(y, tops.ssd(*t, chunk=ck))


def test_ssd_chunk_is_the_reference_wrappers():
    assert [tops.ssd_chunk(s, 128) for s in (1, 8, 100, 128, 2048)] == \
        [8, 8, 104, 128, 128]
    assert tops.ssd_chunk(100, 32) == 32
    _, t = _ssd_inputs(1, 4, 2, 16, 1, 16, seed=1)
    with pytest.raises(ValueError, match="no ssd kernel"):
        tops.ssd(*(Elsewhere(*a.shape) for a in t))


# -- K5's wgmma route: its rounding, emulated ---------------------------------
# (b, s, h, p, g, n, chunk): the sweep, a ragged 1,000-row prompt at
# mamba2-2.7b's widths with 8 heads, and jamba's widths (p 64, n 16).
WGMMA_SSD = SWEEP + [(1, 1000, 8, 64, 1, 128, 128), (1, 300, 8, 64, 2, 16, 128)]
# K5 on the card against its plain version (chip_smoke.py's SSD_TOL): y
# within one bf16 step (rtol 8e-3, atol 1e-3), the f32 state within 1e-4.
ROUTE_TOL = {"y": dict(rtol=8e-3, atol=1e-3), "state": dict(rtol=1e-4,
                                                            atol=1e-4)}


def _bf16_pair(v):
    """``v`` as hi + lo bf16 values: hi = bf16(v), lo = bf16(v - hi)."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def _wgmma_route_emulation(x, dt, A_log, B, C, D, *, chunk,
                           single=frozenset()):
    """The bf16 tensor-core route of K5 step by step in plain torch, rounding
    where the kernel rounds: C B^T from the bf16 inputs with f32 sums; W =
    C B^T exp(la_i - la_j) dt_j in f32, then as a hi + lo bf16 pair against
    bf16 x; the f32 state as a hi + lo pair against bf16 C; V = exp(la_last
    - la_j) dt_j x_j as a pair against bf16 B; every product summed in f32.
    The operands named in ``single`` ("w", "state", "v") are rounded to
    bf16 once instead.  Returns ``(y`` in x's dtype, the final state f32)."""
    def parts(name, v):
        return (v.bfloat16().float(),) if name in single else _bf16_pair(v)

    b, s, h, p = x.shape
    hpg = h // B.shape[2]
    A = -torch.exp(A_log.float())
    xf = x.float()
    Bh = torch.repeat_interleave(B.float(), hpg, dim=2)
    Ch = torch.repeat_interleave(C.float(), hpg, dim=2)
    state = torch.zeros((b, h, p, B.shape[3]))
    ys = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, min(t0 + chunk, s))
        xc, dtc, Bc, Cc = xf[:, sl], dt[:, sl].float(), Bh[:, sl], Ch[:, sl]
        q = xc.shape[1]
        la = torch.cumsum(dtc * A, dim=1)                  # [b,q,h]
        lah = la.transpose(1, 2)
        mask = torch.tril(torch.ones((q, q), dtype=torch.bool))
        ldiff = torch.where(mask, lah[..., :, None] - lah[..., None, :], 0.0)
        w = torch.where(mask, torch.einsum("bihn,bjhn->bhij", Cc, Bc)
                        * torch.exp(ldiff)
                        * dtc.transpose(1, 2)[..., None, :], 0.0)
        y = torch.exp(la)[..., None] * sum(
            torch.einsum("bihn,bhpn->bihp", Cc, part)
            for part in parts("state", state))
        y = y + sum(torch.einsum("bhij,bjhp->bihp", part, xc)
                    for part in parts("w", w))
        ys.append(y + xc * D.float()[None, None, :, None])
        la_last = la[:, -1]
        v = (torch.exp(la_last[:, None] - la) * dtc)[..., None] * xc
        state = state * torch.exp(la_last)[..., None, None] + sum(
            torch.einsum("bjhp,bjhn->bhpn", part, Bc)
            for part in parts("v", v))
    return torch.cat(ys, dim=1).to(x.dtype), state


def _close_at(got, want, rtol, atol):
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


@pytest.mark.parametrize("b,s,h,p,g,n,ck", WGMMA_SSD)
def test_wgmma_route_numerics_match_reference(b, s, h, p, g, n, ck):
    """Rounding W, the state and V to bf16 pairs (new against the Pallas
    kernel, which multiplies f32 operands) keeps y within one bf16 step of
    the plain version and the state within 1e-4, the card's tolerances;
    y also within the reference's bf16 tolerance of its Pallas kernel in
    interpret mode."""
    j, t = _ssd_inputs(b, s, h, p, g, n, seed=7 * s + n, dtype="bfloat16")
    ck = tops.ssd_chunk(s, ck)
    got_y, got_state = _wgmma_route_emulation(*t, chunk=ck)
    want_y, want_state = tref.ssd_chunks_ref(*t, chunk=ck)
    assert got_y.dtype == torch.bfloat16
    assert _close_at(got_y, want_y, **ROUTE_TOL["y"])
    assert _close_at(got_state, want_state, **ROUTE_TOL["state"])
    np.testing.assert_allclose(_np(got_y), _np(jops.ssd(*j, chunk=ck)),
                               **KTOL["bfloat16"])


@pytest.mark.parametrize("single,key", [("w", "y"), ("state", "y"),
                                        ("v", "state")])
def test_wgmma_route_needs_each_bf16_pair(single, key):
    """Why the route pays two wgmmas per f32 operand: with one bf16
    rounding of W or of the state (in C S^T) instead of a hi + lo pair, y
    misses its tolerance; with one of V, the final state misses 1e-4."""
    b, s, h, p, g, n, ck = SWEEP[1]                  # 4 chunks carry a state
    _, t = _ssd_inputs(b, s, h, p, g, n, seed=7 * s + n, dtype="bfloat16")
    got = dict(zip(("y", "state"), _wgmma_route_emulation(
        *t, chunk=ck, single={single})))
    want = dict(zip(("y", "state"), tref.ssd_chunks_ref(*t, chunk=ck)))
    assert not _close_at(got[key], want[key], **ROUTE_TOL[key])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,n", [(16, 32), (32, 64), (64, 16), (64, 64),
                                 (64, 128), (64, 12)])
def test_ssd_route_by_dtype_and_widths(dtype, p, n):
    """bf16 at head dim 64 with whole 16-byte state rows (mamba2-2.7b's n
    128, jamba's n 16) takes the wgmma kernel at every chunk; f32 (wgmma
    would be TF32) and bf16 at other widths the SIMT kernel."""
    from repro_torch.kernels import ssd as k5
    want = "wgmma" if dtype == torch.bfloat16 and p == 64 and n % 8 == 0 \
        else "simt"
    assert {k5.route(dtype, p, n, ck) for ck in (8, 32, 104, 128)} == {want}


# -- models/ssd.py ------------------------------------------------------------
def test_ssd_recurrent_matches_reference():
    j, t = _ssd_inputs(2, 20, 4, 16, 2, 8, seed=11)
    y, st = tssd.ssd_recurrent(*t)
    jy, jst = jssd.ssd_recurrent(*j)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(st), _np(jst), **TOL)
    # from a given state
    init = np.random.default_rng(12).standard_normal(
        (2, 4, 16, 8)).astype(np.float32)
    y, st = tssd.ssd_recurrent(*t, state=torch.from_numpy(init))
    jy, jst = jssd.ssd_recurrent(*j, state=jnp.asarray(init))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(st), _np(jst), **TOL)


@pytest.mark.parametrize("s,chunk", [(32, 8), (30, 8), (5, 16)])
def test_ssd_chunked_matches_reference(s, chunk):
    """Whole chunks, a ragged tail, and one chunk shorter than ``chunk``;
    with and without the state, from zero and from a given state."""
    j, t = _ssd_inputs(2, s, 4, 16, 2, 8, seed=13 + s)
    y, st = tssd.ssd_chunked(*t, chunk=chunk, return_state=True)
    jy, jst = jssd.ssd_chunked(*j, chunk=chunk, return_state=True)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(st), _np(jst), **TOL)
    np.testing.assert_array_equal(_np(tssd.ssd_chunked(*t, chunk=chunk)),
                                  _np(y))
    init = np.random.default_rng(14).standard_normal(
        (2, 4, 16, 8)).astype(np.float32)
    y, st = tssd.ssd_chunked(*t, chunk=chunk, state=torch.from_numpy(init),
                             return_state=True)
    jy, jst = jssd.ssd_chunked(*j, chunk=chunk, state=jnp.asarray(init),
                               return_state=True)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(st), _np(jst), **TOL)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(15)
    b, h, p, g, n = 2, 4, 16, 2, 8
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x = rng.standard_normal((b, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, h)), 0).astype(np.float32)
    A_log = (rng.standard_normal(h) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, g, n)).astype(np.float32)
    C = rng.standard_normal((b, g, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    args = (state, x, dt, A_log, B, C, D)
    y, st = tssd.ssd_decode_step(*map(torch.from_numpy, args))
    jy, jst = jssd.ssd_decode_step(*map(jnp.asarray, args))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(st), _np(jst), **TOL)


@pytest.mark.parametrize("s", [1, 3, 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(s, dtype):
    rng = np.random.default_rng(16)
    x = rng.standard_normal((2, s, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) * 0.5).astype(np.float32)
    got = tssd._causal_conv(torch.from_numpy(x).to(getattr(torch, dtype)),
                            torch.from_numpy(w).to(getattr(torch, dtype)))
    want = jssd._causal_conv(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    assert str(got.dtype).split(".")[-1] == dtype
    tol = TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _mixer_params(seed, d_model=32, d_inner=64, head_dim=16, g=2, n=8, k=4):
    """One Mamba layer's weights as numpy, with the reference's rows for
    A_log, dt_bias and D."""
    rng = np.random.default_rng(seed)
    shapes = jssd.mamba_param_shapes(d_model, d_inner=d_inner,
                                     head_dim=head_dim, n_groups=g,
                                     d_state=n, conv_k=k)
    p = {name: (rng.standard_normal(shape) / math.sqrt(shape[0])
                ).astype(np.float32) for name, shape in shapes.items()}
    h = d_inner // head_dim
    p["mamba_A"] = np.log(np.linspace(1, 16, h)).astype(np.float32)
    p["mamba_dt_bias"] = np.log(np.expm1(np.exp(np.linspace(
        np.log(1e-3), np.log(1e-1), h)))).astype(np.float32)
    p["mamba_D"] = np.ones(h, np.float32)
    p["mamba_gnorm"] = (1 + 0.1 * rng.standard_normal(d_inner)
                        ).astype(np.float32)
    return p, dict(head_dim=head_dim, n_groups=g, d_state=n)


def test_mamba_param_shapes_match_reference():
    kw = dict(d_inner=5120, head_dim=64, n_groups=1, d_state=128, conv_k=4)
    assert tssd.mamba_param_shapes(2560, **kw) == \
        jssd.mamba_param_shapes(2560, **kw)
    kw = dict(d_inner=64, head_dim=16, n_groups=2, d_state=8, conv_k=4)
    assert tssd.mamba_param_shapes(32, **kw) == \
        jssd.mamba_param_shapes(32, **kw)


@pytest.mark.parametrize("return_state", [False, True])
@pytest.mark.parametrize("impl", ["chunked", "recurrent", "pallas"])
def test_mamba2_mixer_matches_reference(impl, return_state):
    """Every impl, s = 21 (ragged against the chunk 8), with and without
    the conv tail and the SSM state for the cache."""
    p, kw = _mixer_params(17)
    x = np.random.default_rng(18).standard_normal((2, 21, 32)).astype(
        np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got = tssd.mamba2_mixer(tp, torch.from_numpy(x), chunk=8, impl=impl,
                            return_state=return_state, **kw)
    want = jssd.mamba2_mixer(jp, jnp.asarray(x), chunk=8, impl=impl,
                             return_state=return_state, **kw)
    if not return_state:
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        return
    (out, (tail, st)), (jout, (jtail, jst)) = got, want
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(tail), _np(jtail), **TOL)
    np.testing.assert_allclose(_np(st), _np(jst), **TOL)
    assert tail.shape == (2, 3, 64 + 2 * 2 * 8)


def test_mamba2_mixer_short_prompt_tail_is_zero_padded():
    """A prompt shorter than the conv window: the tail's leading rows are
    zeros, as the reference's."""
    p, kw = _mixer_params(19)
    x = np.random.default_rng(20).standard_normal((1, 2, 32)).astype(
        np.float32)
    _, (tail, _) = tssd.mamba2_mixer(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        return_state=True, **kw)
    _, (jtail, _) = jssd.mamba2_mixer(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        return_state=True, **kw)
    assert bool((tail[:, 0] == 0).all())
    np.testing.assert_allclose(_np(tail), _np(jtail), **TOL)
    with pytest.raises(ValueError, match="impl"):
        tssd.mamba2_mixer({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), impl="scan", **kw)


def test_mamba2_decode_step_matches_reference():
    """Three decode steps from a prefilled cache, carrying both states."""
    p, kw = _mixer_params(21)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    _, (tail, st) = tssd.mamba2_mixer(tp, torch.from_numpy(x[:, :6]),
                                      return_state=True, **kw)
    _, (jtail, jst) = jssd.mamba2_mixer(jp, jnp.asarray(x[:, :6]),
                                        return_state=True, **kw)
    tc = tssd.MambaCache(conv=tail, ssm=st)
    jc = jssd.MambaCache(conv=jtail, ssm=jst)
    for i in range(6, 9):
        y, tc = tssd.mamba2_decode_step(tp, torch.from_numpy(x[:, i]), tc,
                                        **kw)
        jy, jc = jssd.mamba2_decode_step(jp, jnp.asarray(x[:, i]), jc, **kw)
        np.testing.assert_allclose(_np(y), _np(jy), **TOL)
        np.testing.assert_allclose(_np(tc.conv), _np(jc.conv), **TOL)
        np.testing.assert_allclose(_np(tc.ssm), _np(jc.ssm), **TOL)
    empty = tssd.mamba2_init_cache(2, d_inner=64, head_dim=16, n_groups=2,
                                   d_state=8, conv_k=4, device="cpu")
    jempty = jssd.mamba2_init_cache(2, d_inner=64, head_dim=16, n_groups=2,
                                    d_state=8, conv_k=4)
    for a, ja in zip(empty, jempty):
        assert tuple(a.shape) == ja.shape
        assert str(a.dtype).split(".")[-1] == ja.dtype.name
        assert not bool(a.any())


# -- the slice: reduced mamba2-2.7b -------------------------------------------
def _cfgs(**kw):
    return (replace(jconfigs.get_arch(ARCH).reduced(), **kw),
            replace(tconfigs.get_arch(ARCH).reduced(), **kw))


def _ref_params(jcfg, seed=0):
    p = jlm.init_params(jax.random.key(seed), jcfg)
    return p, tmodels.lm_params_from_numpy(jax.tree.map(np.asarray, p),
                                           device="cpu")


def _tokens(cfg, b=2, s=14, seed=7):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _serve_both(jcfg, tcfg, jp, tp, toks, s):
    """forward over ``toks``; prefill over the first ``s`` tokens, then the
    rest one decode step at a time — in both packages."""
    out = {"jf": jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg),
           "tf": tlm.forward(tp, {"tokens": toks}, tcfg, device="cpu")}
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jcfg,
                         max_len=s + 4)
    tl, tc = tlm.prefill(tp, {"tokens": toks[:, :s]}, tcfg, max_len=s + 4,
                         device="cpu")
    out["jsteps"], out["tsteps"] = [jl], [tl]
    out["jcaches"], out["tcaches"] = [jc], [
        {k: {n: v.clone() for n, v in c.items()} for k, c in tc.items()}]
    for i in range(toks.shape[1] - s):
        step = toks[:, s + i:s + i + 1]
        jl, jc = jlm.decode_step(jp, jc, jnp.asarray(step), jnp.int32(s + i),
                                 jcfg)
        tl, tc2 = tlm.decode_step(tp, tc, step, s + i, tcfg, device="cpu")
        assert tc2 is tc                              # updated in place
        out["jsteps"].append(jl)
        out["tsteps"].append(tl)
        out["jcaches"].append(jc)
        out["tcaches"].append({k: {n: v.clone() for n, v in c.items()}
                               for k, c in tc.items()})
    return out


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_mamba_serve_path_matches_reference(impl):
    """forward, prefill and 2 decode steps of the reduced mamba2-2.7b on the
    reference's weights, with the conv and SSM caches after each call."""
    jcfg, tcfg = _cfgs(ssd_impl=impl, ssd_chunk=8)
    jp, tp = _ref_params(jcfg)
    assert tlm.param_count(tp) == jlm.param_count(jp)
    toks = _tokens(jcfg)
    out = _serve_both(jcfg, tcfg, jp, tp, toks, 12)
    assert out["tf"].shape == (2, 14, tcfg.vocab_size)
    np.testing.assert_allclose(_np(out["tf"]), _np(out["jf"]), **TOL)
    for jl, tl in zip(out["jsteps"], out["tsteps"]):
        assert tl.shape == (2, tcfg.padded_vocab)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for jc, tc in zip(out["jcaches"], out["tcaches"]):
        assert set(tc) == set(jc) == {"p0"}
        assert tc["p0"]["ssm"].dtype == torch.float32
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(_np(tc["p0"][name]),
                                       _np(jc["p0"][name]), **TOL)


def test_bf16_mamba_serve_path_matches_reference():
    """The serve path's dtype: bf16 weights, activations and conv cache;
    f32 norm scales, Mamba rows, SSM state and logits."""
    jcfg, tcfg = _cfgs(dtype="bfloat16", ssd_impl="pallas", ssd_chunk=8)
    jp, tp = _ref_params(jcfg, seed=3)
    stack = tp["stack"]["p0"]
    assert stack["mamba_in"].dtype == torch.bfloat16
    for name in ("mamba_A", "mamba_dt_bias", "mamba_D", "mamba_norm",
                 "mamba_gnorm"):
        assert stack[name].dtype == torch.float32
    out = _serve_both(jcfg, tcfg, jp, tp, _tokens(jcfg, seed=10), 12)
    np.testing.assert_allclose(_np(out["tf"]), _np(out["jf"]),
                               rtol=0, atol=2e-2)
    for jl, tl in zip(out["jsteps"], out["tsteps"]):
        np.testing.assert_allclose(_np(tl[:, :tcfg.vocab_size]),
                                   _np(jl[:, :tcfg.vocab_size]),
                                   rtol=0, atol=2e-2)
    assert out["tcaches"][-1]["p0"]["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["chunked", "recurrent", "pallas"])
def test_mamba_prefill_then_decode_equals_forward(impl):
    """Inside the port: prefill + 2 decode steps == teacher-forced forward
    (tests/test_archs.py:75 for the port), a prompt that is no multiple of
    the chunk."""
    cfg = replace(tconfigs.get_arch(ARCH).reduced(), ssd_impl=impl,
                  ssd_chunk=8)
    params = tlm.init_params(0, cfg, device="cpu")
    toks = _tokens(cfg, s=15, seed=11)
    full = tlm.forward(params, {"tokens": toks}, cfg, device="cpu")
    lg, cache = tlm.prefill(params, {"tokens": toks[:, :13]}, cfg,
                            max_len=16, device="cpu")
    np.testing.assert_allclose(_np(lg[:, :cfg.vocab_size]), _np(full[:, 12]),
                               **TOL)
    for i in range(2):
        lg, cache2 = tlm.decode_step(params, cache, toks[:, 13 + i:14 + i],
                                     13 + i, cfg, device="cpu")
        assert cache2 is cache
        np.testing.assert_allclose(_np(lg[:, :cfg.vocab_size]),
                                   _np(full[:, 13 + i]), **TOL)
    assert bool((lg[:, cfg.vocab_size:] == -1e30).all())


def test_pallas_prefill_state_equals_chunked_prefill():
    """K5's own final state (no second pass) seeds the same cache as the
    chunked route's, and the same logits."""
    cfg = tconfigs.get_arch(ARCH).reduced()
    params = tlm.init_params(1, cfg, device="cpu")
    toks = _tokens(cfg, s=37, seed=12)
    got, gc = tlm.prefill(params, {"tokens": toks},
                          replace(cfg, ssd_impl="pallas"), device="cpu")
    want, wc = tlm.prefill(params, {"tokens": toks}, cfg, device="cpu")
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(_np(gc["p0"][name]), _np(wc["p0"][name]),
                                   **TOL)


# -- init and weights ---------------------------------------------------------
def test_published_widths_shapes_and_param_count():
    """mamba2-2.7b at its published widths and depth, without allocating:
    the block shapes are the reference's and the count is 2,702,624,256."""
    j, t = jconfigs.get_arch(ARCH), tconfigs.get_arch(ARCH)
    plan = tlm.layer_plan(t)
    assert [k.mixer for k in plan] == ["mamba"] and plan[0].mlp == "none"
    shapes = tlm._block_shapes(t, plan[0])
    assert shapes == jlm._block_shapes(j, jlm.layer_plan(j)[0])
    assert shapes["mamba_in"] == (2560, 2 * 5120 + 2 * 128 + 80)
    n_periods = t.n_layers // len(plan)
    count = (n_periods * sum(math.prod(s) for s in shapes.values())
             + t.padded_vocab * t.d_model + t.d_model)
    assert t.padded_vocab == 50_432 and t.tie_embeddings
    assert count == PUBLISHED_PARAMS
    ref = jax.eval_shape(lambda k: jlm.init_params(k, j), jax.random.key(0))
    assert sum(math.prod(x.shape) for x in jax.tree.leaves(ref)) == count


def test_init_params_mamba_rows_match_reference():
    """The deterministic per-head rows in f32 whatever ``cfg.dtype``; the
    drawn leaves in ``cfg.dtype``; the layout the reference's."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    tp = tlm.init_params(0, tcfg, device="cpu")
    jp = jlm.init_params(jax.random.key(0), jcfg)
    ref = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                         jax.random.key(0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == leaf.dtype.name
    for name in ("mamba_A", "mamba_dt_bias", "mamba_D"):
        got = tp["stack"]["p0"][name]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(jp["stack"]["p0"][name]),
                                   rtol=1e-6, atol=0)
    assert tlm.param_count(tp) == jlm.param_count(jp)


def test_lm_params_from_numpy_carries_mamba_leaves_exactly():
    jcfg, _ = _cfgs(dtype="bfloat16")
    p_np = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(5), jcfg))
    tp = tmodels.lm_params_from_numpy(p_np, device="cpu")
    for name, leaf in p_np["stack"]["p0"].items():
        got = tp["stack"]["p0"][name]
        assert str(got.dtype).split(".")[-1] == leaf.dtype.name
        np.testing.assert_array_equal(_np(got), leaf.astype(np.float32))
    back = tmodels.lm_params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p_np)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_init_cache_matches_reference_layout():
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    tc = tlm.init_cache(tcfg, 3, 10, device="cpu")
    jc = jlm.init_cache(jcfg, 3, 10)
    assert set(tc) == set(jc)
    for key, c in jc.items():
        assert set(tc[key]) == set(c)
        for name, leaf in c.items():
            assert tuple(tc[key][name].shape) == leaf.shape
            assert str(tc[key][name].dtype).split(".")[-1] == \
                leaf.dtype.name
            assert not bool(tc[key][name].any())


def test_jamba_serve_path_matches_reference():
    """The reduced jamba (8 layers a period: Mamba-2 blocks, one attention
    block, MoE on odd layers, scatter dispatch) through K5's plain version:
    forward, prefill and 2 decode steps on the reference's weights, with
    every cache leaf after the last step."""
    kw = dict(ssd_impl="pallas", ssd_chunk=8)
    jcfg = replace(jconfigs.get_arch("jamba-v0.1-52b").reduced(), **kw)
    tcfg = replace(tconfigs.get_arch("jamba-v0.1-52b").reduced(), **kw)
    plan = tlm.layer_plan(tcfg)
    assert {k.mixer for k in plan} == {"mamba", "attn"}
    assert {k.mlp for k in plan} == {"swiglu", "moe"}
    jp = jlm.init_params(jax.random.key(0), jcfg)
    tp = tmodels.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    out = _serve_both(jcfg, tcfg, jp, tp, _tokens(jcfg), 12)
    np.testing.assert_allclose(_np(out["tf"]), _np(out["jf"]), **TOL)
    for jl, tl in zip(out["jsteps"], out["tsteps"]):
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for key, c in out["jcaches"][-1].items():
        for name, leaf in c.items():
            np.testing.assert_allclose(_np(out["tcaches"][-1][key][name]),
                                       _np(leaf), err_msg=f"{key}/{name}",
                                       **TOL)
