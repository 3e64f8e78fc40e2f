"""The port's MoE layers — ``_moe_dispatch`` (both impls), ``moe_layer``,
``moe_layer_3d``, the one-shard expert-parallel body, and the reduced MoE
archs' serve path — against the JAX reference on the CPU.

Inputs are made with numpy from a seed and given to both packages; the
reference's weights (``jax.random`` init) are carried across with
``lm_params_from_numpy``.  Reduced configs (f32, d_model 64, 4 experts
top-2, experts 64 wide).  Tolerances, and why:

* routing (top-k indices, dropped-slot counts), shapes, leaf layouts:
  exact;
* f32 outputs and the aux term: rtol 1e-5, atol 1e-5 — the two libraries
  sum GEMMs and reductions in other orders (measured at most 8e-6 on
  logits up to ~3); no routing decision of these draws lies within that
  distance of a tie;
* bf16 dispatch: both round the expert products and the gate-weighted sum
  to bf16 at the same places, but a sum in another order moves a value to
  the neighbouring bf16 number now and then: atol 2e-2 + rtol 2e-2 on
  outputs of magnitude ~1 (one bf16 step is 2^-8 relative);
* the ``act_shard_moe`` split's ranks' contributions summed, against the
  port's unsplit layer: rtol 1e-6, atol 1e-6 (the same products, each
  token's ``k`` terms summed in another order);
* inside the port, prefill + decode against a teacher-forced forward,
  dropless (``capacity_factor = n_experts / top_k``, as
  ``tests/test_archs.py:80``): rtol 1e-5, atol 1e-5.
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
from repro.distributed.ep_dispatch import make_ep_dispatch  # noqa: E402
from repro.launch.mesh import mesh_axis_types_kwargs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch.distributed.sharding import ExpertSplit  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

MOE = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "jamba-v0.1-52b"]
GRANITE_PARAMS = 3_299_182_080     # the reference's count (49,408-row embed)
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
T, D, E, F, K = 37, 32, 8, 16, 2   # a ragged token count; C = 11 at cf 1.25


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _moe_inputs(seed=0, t=T):
    """x [t, D], router [D, E], gate/up [E, D, F], down [E, F, D]."""
    rng = np.random.default_rng(seed)
    n = lambda shape, s=1.0: rng.standard_normal(shape,  # noqa: E731
                                                 dtype=np.float32) * s
    return (n((t, D)), n((D, E), 0.3), n((E, D, F), 0.2), n((E, D, F), 0.2),
            n((E, F, D), 0.2))


def _both(arrays, dtype):
    """The same arrays for the reference (jnp) and the port (torch)."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _overflow(x, router_w, cf, t=T, k=K):
    """Slots over capacity: Σ_e max(0, n_e - C), from the reference's
    routing."""
    probs = jax.nn.softmax((jnp.asarray(x) @ jnp.asarray(router_w))
                           .astype(jnp.float32), -1)
    idx = np.asarray(jax.lax.top_k(probs, k)[1])
    C = max(1, int(cf * k * t / E))
    return int(np.maximum(np.bincount(idx.ravel(), minlength=E) - C, 0)
               .sum())


# -- _moe_dispatch --------------------------------------------------------------
@pytest.mark.parametrize("cf", [1.25, E / K], ids=["drops", "dropless"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_moe_dispatch_matches_reference(impl, dtype, cf):
    arrays = _moe_inputs()
    dropped = _overflow(arrays[0], arrays[1], cf)
    assert (dropped > 0) == (cf == 1.25)        # the draws drop at 1.25
    jx, tx = _both(arrays, dtype)
    jo, ja = jlayers._moe_dispatch(*jx, top_k=K, capacity_factor=cf,
                                   impl=impl)
    to, ta = tlayers._moe_dispatch(*tx, top_k=K, capacity_factor=cf,
                                   impl=impl)
    assert to.dtype == tx[0].dtype and to.shape == (T, D)
    assert ta.dtype == torch.float32 and ta.shape == ()
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(to), _np(jo), **tol)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_both_impls_agree_and_dropped_slots_add_nothing():
    """The einsum and scatter impls compute one function; a token whose
    slots are all dropped comes out zero."""
    x, rw, g, u, d = (torch.from_numpy(a) for a in _moe_inputs(1))
    x[5:] = x[4]                                 # one expert's queue fills
    outs = [tlayers._moe_dispatch(x, rw, g, u, d, top_k=K,
                                  capacity_factor=1.25, impl=impl)
            for impl in ("einsum", "scatter")]
    np.testing.assert_allclose(_np(outs[0][0]), _np(outs[1][0]), **TOL)
    assert float(outs[0][1]) == float(outs[1][1])
    C = int(1.25 * K * T / E)
    assert not bool(outs[1][0][C + 4:].any())    # past capacity: dropped
    assert bool(outs[1][0][:C + 4].abs().sum(-1).gt(0).all())


def test_top_k_breaks_ties_lower_index_first():
    """``jax.lax.top_k``'s order: largest first, equal values lower index
    first — on rows full of ties, at and inside the k-th place."""
    rng = np.random.default_rng(2)
    probs = (rng.integers(0, 4, (64, E)) / 4).astype(np.float32)
    for k in (1, 2, 3, 5):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tlayers._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_duplicate_router_columns_route_as_the_reference(impl):
    """A router whose columns 4..7 repeat 0..3, on values whose products
    and sums are exact in f32: every logit ties with its twin, so at top-3
    each row ties inside the top k and at its edge, and the port routes,
    drops and aggregates as the reference does (its gate indices, which
    slots drop, ``out``, ``aux``)."""
    k = 3
    rng = np.random.default_rng(3)
    x = (rng.integers(-3, 4, (T, D)) / 4).astype(np.float32)
    rw = (rng.integers(-2, 3, (D, E // 2)) / 8).astype(np.float32)
    rw = np.concatenate([rw, rw], axis=1)
    _, _, g, u, d = _moe_inputs(3)
    logits = x @ rw
    top = np.sort(logits, axis=-1)[:, ::-1]
    assert (top[:, 0] == top[:, 1]).all() and (top[:, 2] == top[:, 3]).all()
    probs = torch.softmax(torch.from_numpy(logits), -1)
    _, ti = tlayers._top_k(probs, k)
    _, ji = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert _overflow(x, rw, 1.25, k=k) > 0
    jo, ja = jlayers._moe_dispatch(*map(jnp.asarray, (x, rw, g, u, d)),
                                   top_k=k, impl=impl)
    to, ta = tlayers._moe_dispatch(*map(torch.from_numpy, (x, rw, g, u, d)),
                                   top_k=k, impl=impl)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def _rank_split(m: int, r: int = 0):
    """The ``act_shard_moe`` split over ``model`` as rank ``r`` of a (1,
    ``m``) mesh sees it (a counting mesh on the CPU: no process group)."""
    return ExpertSplit(Mesh((1, m), ("data", "model"), "meta",
                            torch.device("cpu"), rank=r))


def test_expert_parallel_hooks_raise():
    """``ep_shard`` (the ``act_shard_moe`` hook) on a one-rank split is the
    plain call, bitwise, under both impls, and a config carrying it builds
    and runs; ``moe_dispatch`` runs: every MoE layer of a reduced
    granite-moe goes through it, and a hook that dispatches as
    ``moe_impl`` would gives the plain path's logits."""
    x, rw, g, u, d = (torch.from_numpy(a) for a in _moe_inputs())
    for impl in ("einsum", "scatter"):
        want = tlayers._moe_dispatch(x, rw, g, u, d, top_k=K, impl=impl)
        got = tlayers._moe_dispatch(x, rw, g, u, d, top_k=K, impl=impl,
                                    ep_shard=_rank_split(1))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    base = replace(tconfigs.get_arch("granite-moe-3b-a800m").reduced(),
                   moe_impl="scatter")
    tlm.init_params(0, replace(base, act_shard_moe=_rank_split(1)),
                    device="cpu")
    calls = []

    def hook(h, router, gate, up, down, *, top_k, capacity_factor):
        calls.append(tuple(h.shape))
        return tlayers.moe_layer_3d(h, router, gate, up, down, top_k=top_k,
                                    capacity_factor=capacity_factor,
                                    impl="scatter")

    params = tlm.init_params(0, base, device="cpu")
    toks = _tokens(base)
    want = tlm.forward(params, {"tokens": toks}, base, device="cpu")
    got = tlm.forward(params, {"tokens": toks}, replace(base,
                                                        moe_dispatch=hook),
                      device="cpu")
    assert calls == [(2, 14, base.d_model)] * base.n_layers
    assert torch.equal(got, want)


# (E, m, capacity factor, the buffers' split): C = int(cf·k·T/E).
SPLITS = [(8, 2, 1.25, 0), (8, 4, 1.25, 0), (6, 4, 1.0, 1),
          (6, 4, 1.25, None)]


@pytest.mark.parametrize("E_,m,cf,dim", SPLITS,
                         ids=["experts-2", "experts-4", "capacity-4",
                              "neither-4"])
def test_expert_split_contributions_sum_to_the_layer(E_, m, cf, dim):
    """Under the ``act_shard_moe`` split each of ``m`` ranks routes every
    token and computes its block of the ``"scatter"`` buffers — its
    ``E/m`` experts (from the whole weights or from its own block), or
    its ``C/m`` capacity rows of every expert, or (neither divides) rank 0
    the whole layer: the ranks' contributions sum to the reference's
    output (within 1e-5) and to the port's own unsplit layer, outputs and
    gradients (within 1e-6: each token's ``k`` terms are the same
    products, summed in another order where ``k`` > 2 ranks hold them);
    every rank's aux term is the whole layer's."""
    rng = np.random.default_rng(3)
    n = lambda shape, s: rng.standard_normal(shape,  # noqa: E731
                                             dtype=np.float32) * s
    arrays = (n((T, D), 1.0), n((D, E_), 0.3), n((E_, D, F), 0.2),
              n((E_, D, F), 0.2), n((E_, F, D), 0.2))
    C = int(cf * K * T / E_)
    assert ExpertSplit.dim(_rank_split(m), E_, C) == dim
    idx = np.asarray(jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(arrays[0]) @ jnp.asarray(arrays[1]), -1), K)[1])
    assert (np.bincount(idx.ravel(), minlength=E_) > C).any()    # drops
    cot = torch.from_numpy(n((T, D), 1.0))

    def run(split, weights=None):
        ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
        w = ins[2:] if weights is None else weights(ins[2:])
        out, aux = tlayers._moe_dispatch(ins[0], ins[1], *w, top_k=K,
                                         capacity_factor=cf,
                                         impl="scatter", ep_shard=split)
        (out * cot).sum().backward()
        return out.detach(), aux.detach(), [t.grad for t in ins]

    want, want_aux, want_g = run(None)
    jo, ja = jlayers._moe_dispatch(*map(jnp.asarray, arrays), top_k=K,
                                   capacity_factor=cf, impl="scatter")
    for own in ([False, True] if dim == 0 else [False]):
        outs, grads = [], []
        for r in range(m):
            sl = (lambda w, r=r: [t[r * E_ // m:(r + 1) * E_ // m]
                                  for t in w]) if own else None
            o, a, gr = run(_rank_split(m, r), sl)
            assert torch.equal(a, want_aux)
            outs.append(o)
            grads.append(gr)
        got = sum(outs)
        tol = dict(rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got, want, **tol)
        np.testing.assert_allclose(_np(got), _np(jo), **TOL)
        np.testing.assert_allclose(float(want_aux), float(ja), rtol=1e-6)
        for j in range(5):
            torch.testing.assert_close(sum(g[j] for g in grads), want_g[j],
                                       **tol)
        if dim is None:             # rank 0 the whole layer, the rest zero
            assert all(not o.any() for o in outs[1:])


# -- moe_layer, moe_layer_3d ------------------------------------------------------
@pytest.mark.parametrize("impl,remat", [("einsum", False), ("scatter", True)])
def test_moe_layer_token_chunks_match_reference(impl, remat):
    """37 tokens in chunks of 16 (the tail padded): each chunk routed on its
    own, the aux term averaged over chunks."""
    jx, tx = _both(_moe_inputs(4), "float32")
    jo, ja = jlayers.moe_layer(*jx, top_k=K, impl=impl, token_chunk=16,
                               remat=remat)
    to, ta = tlayers.moe_layer(*tx, top_k=K, impl=impl, token_chunk=16,
                               remat=remat)
    whole, _ = tlayers.moe_layer(*tx, top_k=K, impl=impl)
    assert to.shape == (T, D)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    assert not torch.allclose(to, whole)         # per-chunk capacity


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_moe_layer_3d_seq_chunks_match_reference(impl):
    """[3, 13, D] in sequence chunks of 5 (the tail padded), the batch kept
    whole in each chunk."""
    arrays = list(_moe_inputs(5, t=39))
    arrays[0] = arrays[0].reshape(3, 13, D)
    jx, tx = _both(arrays, "float32")
    jo, ja = jlayers.moe_layer_3d(*jx, top_k=K, impl=impl, seq_chunk=5)
    to, ta = tlayers.moe_layer_3d(*tx, top_k=K, impl=impl, seq_chunk=5)
    assert to.shape == (3, 13, D)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)
    jo, ja = jlayers.moe_layer_3d(*jx, top_k=K, impl=impl)
    to, ta = tlayers.moe_layer_3d(*tx, top_k=K, impl=impl)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_remat_changes_no_bit_of_the_moe_gradients():
    x, rw, g, u, d = (torch.from_numpy(a) for a in _moe_inputs(6))
    grads = []
    for remat in (False, True):
        ws = [w.clone().requires_grad_() for w in (rw, g, u, d)]
        out, aux = tlayers.moe_layer(x, *ws, top_k=K, impl="scatter",
                                     token_chunk=16, remat=remat)
        (out.square().sum() + aux).backward()
        grads.append([w.grad for w in ws])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_local_moe_at_one_shard_equals_scatter():
    """``distributed/ep_dispatch.py``'s ``_local_moe`` under a one-device
    mesh (model size 1: every expert local, an identity psum) is the
    port's ``"scatter"`` dispatch."""
    arrays = list(_moe_inputs(7, t=36))
    arrays[0] = arrays[0].reshape(2, 18, D)
    axes = ("data", "model")
    mesh = jax.make_mesh((1, 1), axes, **mesh_axis_types_kwargs(axes))
    disp = make_ep_dispatch(mesh, batch_axes=("data",), fsdp_axis="data")
    jx, tx = _both(arrays, "float32")
    for cf in (1.25, E / K):
        jo, ja = jax.jit(lambda *a: disp(*a, top_k=K,
                                         capacity_factor=cf))(*jx)
        to, ta = tlayers.moe_layer_3d(*tx, top_k=K, capacity_factor=cf,
                                      impl="scatter")
        np.testing.assert_allclose(_np(to), _np(jo), **TOL)
        np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


# -- the reduced MoE archs ---------------------------------------------------------
def _cfgs(name, **kw):
    return (replace(jconfigs.get_arch(name).reduced(), **kw),
            replace(tconfigs.get_arch(name).reduced(), **kw))


def _ref_params(jcfg, seed=0):
    p = jlm.init_params(jax.random.key(seed), jcfg)
    return p, tmodels.lm_params_from_numpy(jax.tree.map(np.asarray, p),
                                           device="cpu")


def _tokens(cfg, b=2, s=14, seed=7):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _serve_both(jcfg, tcfg, jp, tp, toks, s):
    """forward over ``toks``, prefill over its first ``s`` tokens, then the
    rest decoded one by one, in both packages: (reference, port) logits of
    forward and of each serve call, and the final caches."""
    jf = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    tf = tlm.forward(tp, {"tokens": toks}, tcfg, device="cpu")
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, jcfg,
                         max_len=s + 4)
    tl, tc = tlm.prefill(tp, {"tokens": toks[:, :s]}, tcfg, max_len=s + 4,
                         device="cpu")
    steps = [(jl, tl)]
    for i in range(toks.shape[1] - s):
        step = toks[:, s + i:s + i + 1]
        jl, jc = jlm.decode_step(jp, jc, jnp.asarray(step), jnp.int32(s + i),
                                 jcfg)
        tl, tc = tlm.decode_step(tp, tc, step, s + i, tcfg, device="cpu")
        steps.append((jl, tl))
    return (jf, tf), steps, (jc, tc)


SERVE = [("granite-moe-3b-a800m", "einsum", None),
         ("granite-moe-3b-a800m", "scatter", None),
         ("granite-moe-3b-a800m", "einsum", "dropless"),
         ("qwen3-moe-235b-a22b", "scatter", None),
         ("qwen3-moe-235b-a22b", "einsum", "dropless")]


@pytest.mark.parametrize("name,impl,cf", SERVE,
                         ids=["-".join(filter(None, c)) for c in SERVE])
def test_moe_serve_path_matches_reference(name, impl, cf):
    """forward, prefill and 2 decode steps of a reduced MoE arch on the
    reference's weights: at capacity factor 1.25 forward (28 tokens, C =
    17) and prefill (24, C = 15) may drop slots, decode never does.  (The
    reduced jamba's is in tests/test_torch_ssd.py.)"""
    kw = dict(moe_impl=impl)
    if cf == "dropless":
        base = jconfigs.get_arch(name).reduced()
        kw["capacity_factor"] = base.n_experts / base.top_k
    jcfg, tcfg = _cfgs(name, **kw)
    jp, tp = _ref_params(jcfg)
    assert tlm.param_count(tp) == jlm.param_count(jp)
    toks = _tokens(jcfg)
    (jf, tf), steps, (jc, tc) = _serve_both(jcfg, tcfg, jp, tp, toks, 12)
    assert tf.shape == (2, 14, tcfg.vocab_size)
    np.testing.assert_allclose(_np(tf), _np(jf), **TOL)
    for jl, tl in steps:
        assert tl.shape == (2, tcfg.padded_vocab)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for key, c in jc.items():
        for leaf, val in c.items():
            np.testing.assert_allclose(_np(tc[key][leaf]), _np(val), **TOL)


@pytest.fixture
def routing_margins(monkeypatch):
    """Records, for each ``_moe_dispatch`` call in order, every token's
    relative gap between its k-th and (k+1)-th router probabilities."""
    calls = []
    inner = tlayers._moe_dispatch

    def record(x, router_w, *args, top_k, **kw):
        probs = torch.softmax((x @ router_w).float(), -1)
        top = torch.sort(probs, dim=-1, descending=True).values
        calls.append((top[:, top_k - 1] - top[:, top_k]) / top[:, top_k - 1])
        return inner(x, router_w, *args, top_k=top_k, **kw)

    monkeypatch.setattr(tlayers, "_moe_dispatch", record)
    return calls


# bf16 logits carry 8 significant bits, and the two libraries' bf16 hidden
# states differ by about one bf16 step (2^-8 relative): a router logit of
# magnitude ~2 then moves by ~2^-7, which changes the ratio of two experts'
# probabilities by ~2^-6.  A token whose k-th and (k+1)-th probabilities lie
# closer than that may be routed to another expert by the other library,
# and its logits then move by O(gate x expert output), not by roundings.
BF16_TIE_GAP = 2.0 ** -6


def test_bf16_moe_serve_path_matches_reference(routing_margins):
    """granite-moe's serve dtype: bf16 weights and activations through the
    scatter dispatch, f32 router logits and norm scales.  Held at atol 2e-2
    on every position whose routing is no near-tie (``BF16_TIE_GAP``) at
    any layer; those near-ties are counted and must be a minority."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", dtype="bfloat16",
                       moe_impl="scatter", attn_impl="pallas")
    jp, tp = _ref_params(jcfg, seed=3)
    assert tp["stack"]["p0"]["moe_gate"].dtype == torch.bfloat16
    assert tp["stack"]["p0"]["mlp_norm"].dtype == torch.float32
    toks = _tokens(jcfg, seed=10)
    (jf, tf), steps, _ = _serve_both(jcfg, tcfg, jp, tp, toks, 12)
    # forward's routing: the first n_layers calls, each over [b * s] tokens
    gap = torch.stack(routing_margins[:tcfg.n_layers]).reshape(
        tcfg.n_layers, *toks.shape).amin(0)
    clear = (gap >= BF16_TIE_GAP).numpy()
    assert clear.mean() > 0.5
    np.testing.assert_allclose(_np(tf)[clear], _np(jf)[clear], rtol=0,
                               atol=2e-2)
    for i, (jl, tl) in enumerate(steps):     # positions 11, 12, 13
        rows = clear[:, 11 + i]
        np.testing.assert_allclose(_np(tl[:, :tcfg.vocab_size])[rows],
                                   _np(jl[:, :tcfg.vocab_size])[rows],
                                   rtol=0, atol=2e-2)


@pytest.mark.parametrize("name", MOE)
def test_moe_prefill_then_decode_equals_forward(name):
    """Inside the port, dropless (``tests/test_archs.py:80``): prefill + 2
    decode steps == teacher-forced forward."""
    base = tconfigs.get_arch(name).reduced()
    cfg = replace(base, capacity_factor=base.n_experts / base.top_k)
    params = tlm.init_params(0, cfg, device="cpu")
    toks = _tokens(cfg, s=14, seed=11)
    full = tlm.forward(params, {"tokens": toks}, cfg, device="cpu")
    lg, cache = tlm.prefill(params, {"tokens": toks[:, :12]}, cfg,
                            max_len=16, device="cpu")
    np.testing.assert_allclose(_np(lg[:, :cfg.vocab_size]), _np(full[:, 11]),
                               **TOL)
    for i in range(2):
        lg, cache = tlm.decode_step(params, cache, toks[:, 12 + i:13 + i],
                                    12 + i, cfg, device="cpu")
        np.testing.assert_allclose(_np(lg[:, :cfg.vocab_size]),
                                   _np(full[:, 12 + i]), **TOL)


# -- weights ---------------------------------------------------------------------
def test_granite_published_widths_and_param_count():
    """granite-moe-3b-a800m at its published widths and depth, without
    allocating: the reference's block shapes, 3,299,182,080 params."""
    j, t = (c.get_arch("granite-moe-3b-a800m") for c in (jconfigs, tconfigs))
    plan = tlm.layer_plan(t)
    assert plan == [tlm.LayerKind("attn", "moe")]
    shapes = tlm._block_shapes(t, plan[0])
    assert shapes == jlm._block_shapes(j, jlm.layer_plan(j)[0])
    assert shapes["moe_gate"] == (40, 1536, 512)
    assert shapes["router"] == (1536, 40)
    count = (t.n_layers * sum(math.prod(s) for s in shapes.values())
             + t.padded_vocab * t.d_model + t.d_model)
    assert count == GRANITE_PARAMS
    ref = jax.eval_shape(lambda k: jlm.init_params(k, j), jax.random.key(0))
    assert sum(math.prod(x.shape) for x in jax.tree.leaves(ref)) == count
    assert len(jax.tree.leaves(ref)) == 12


@pytest.mark.parametrize("name", MOE)
def test_init_params_and_numpy_round_trip_carry_moe_leaves(name):
    """``init_params`` lays out the MoE leaves (``[n_periods, E, D, F]``
    stacks) as the reference does, and ``lm_params_from_numpy`` /
    ``lm_params_to_numpy`` carry the reference's bf16 weights both ways
    exactly, in JAX's leaf order."""
    jcfg, tcfg = _cfgs(name, dtype="bfloat16")
    tp = tlm.init_params(0, tcfg, device="cpu")
    ref = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                         jax.random.key(0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == leaf.dtype.name
    p_np = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(5), jcfg))
    back = tmodels.lm_params_to_numpy(
        tmodels.lm_params_from_numpy(p_np, device="cpu"))
    assert [p for p, _ in jax.tree_util.tree_flatten_with_path(back)[0]] \
        == [p for p, _ in jax.tree_util.tree_flatten_with_path(p_np)[0]]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p_np)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
