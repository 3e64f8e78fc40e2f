"""The port's SR model against ``repro.models.papertasks`` (reference
weights carried across as numpy), loss and grads to rtol 1e-5.  IC, TG
and MLM are held in ``test_torch_papertasks.py``."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models import papertasks as jpt  # noqa: E402
from repro_torch.models import papertasks as tpt  # noqa: E402

SMALL = dict(width=64, n_blocks=2)
TOL = dict(rtol=1e-5, atol=1e-6)


def _batch(seed, lanes=None, b=8):
    rng = np.random.default_rng(seed)
    lead = () if lanes is None else (lanes,)
    return {"x": rng.standard_normal(lead + (b, 64), dtype=np.float32),
            "y": rng.integers(0, 35, lead + (b,)).astype(np.int32)}


def _ref_params(seed=0, **kw):
    p, loss = jpt.make_task_model("sr", jax.random.key(seed), **(kw or SMALL))
    return {k: np.asarray(v) for k, v in p.items()}, loss


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sr_loss_and_grads_match_reference(seed):
    p_np, jloss = _ref_params(seed)
    batch = _batch(seed)
    jl, jg = jax.value_and_grad(jloss)(
        jax.tree.map(jax.numpy.asarray, p_np),
        jax.tree.map(jax.numpy.asarray, batch))
    tp = {k: v.requires_grad_() for k, v in
          tpt.params_from_numpy(p_np, device="cpu").items()}
    tl = tpt.TASK_MODELS["sr"].loss_fn(tp, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    for k in p_np:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jg[k]),
                                   **TOL)


def test_lane_stacked_loss_is_per_lane_loss():
    """Stacked params/batch give each lane the loss it has alone."""
    lanes = [_ref_params(s)[0] for s in range(3)]
    batch = _batch(9, lanes=3)
    stacked = {k: torch.from_numpy(np.stack([p[k] for p in lanes]))
               for k in lanes[0]}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_fn = tpt.TASK_MODELS["sr"].loss_fn
    got = loss_fn(stacked, tb)
    assert got.shape == (3,)
    for i, p in enumerate(lanes):
        one = loss_fn(tpt.params_from_numpy(p, device="cpu"),
                      {k: v[i] for k, v in tb.items()})
        np.testing.assert_allclose(float(got[i]), float(one), rtol=1e-6)


def test_full_width_sr_matches_published_size():
    params, _ = tpt.make_task_model("sr", 1337, device="cpu")
    ref_shapes = jax.eval_shape(
        lambda k: jpt.make_task_model("sr", k)[0], jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: tuple(v.shape) for k, v in ref_shapes.items()}
    assert len(params) == 18
    assert sum(math.prod(v.shape) for v in params.values()) == 4_244_992
    assert all(v.dtype == torch.float32 for v in params.values())


def test_init_is_seeded_truncated_fan_in():
    a, _ = tpt.make_task_model("sr", 3, device="cpu", **SMALL)
    b, _ = tpt.make_task_model("sr", 3, device="cpu", **SMALL)
    c, _ = tpt.make_task_model("sr", 4, device="cpu", **SMALL)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["stem"], c["stem"])
    w = a["w1_0"]                        # fan_in 64 -> |w| <= 2/sqrt(64)
    assert float(w.abs().max()) <= 2.0 / 8.0 + 1e-7


def test_init_is_built_from_randn_draws():
    """dense_init keeps every seeded randn draw inside ±2 where it fell
    (and redraws the rest): the weights depend on randn's stream alone,
    which PyTorch keeps across releases — trunc_normal_'s it does not."""
    from repro_torch.models.layers import dense_init
    w = dense_init(torch.Generator().manual_seed(11), (300, 40))
    raw = torch.randn((300, 40), generator=torch.Generator().manual_seed(11))
    keep = raw.abs() <= 2.0
    assert not bool(keep.all())                       # some were redrawn
    assert torch.equal(w[keep], raw[keep] * (1.0 / math.sqrt(300)))
    assert float(w.abs().max()) <= 2.0 / math.sqrt(300)


def _dense_init_whole_tensor(gen, shape, dtype, scale):
    """dense_init's redraw as first written: test the whole tensor after
    every redraw (the reference loop the faster one must equal)."""
    w = torch.randn(shape, generator=gen)
    bad = w.abs() > 2.0
    while bool(bad.any()):
        w[bad] = torch.randn(int(bad.sum()), generator=gen)
        bad = w.abs() > 2.0
    return (w * scale).to(dtype)


@pytest.mark.parametrize("shape,dtype", [((300, 40), torch.float32),
                                         ((7,), torch.float32),
                                         ((3, 512, 96), torch.bfloat16),
                                         ((20_000, 64), torch.bfloat16)])
def test_dense_init_equals_the_whole_tensor_redraw(shape, dtype):
    """Bit for bit, and the generator left in the same state (the next
    leaf's draw equal too)."""
    from repro_torch.models.layers import dense_init
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    scale = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
    for _ in range(2):
        got = dense_init(g1, shape, dtype)
        want = _dense_init_whole_tensor(g2, shape, dtype, scale)
        assert got.dtype == dtype
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_numpy_round_trip_is_exact():
    p_np, _ = _ref_params(5)
    back = tpt.params_to_numpy(tpt.params_from_numpy(p_np, device="cpu"))
    for k in p_np:
        np.testing.assert_array_equal(back[k], p_np[k])


def test_unported_tasks_raise():
    """Every task of the paper is ported now: each of the four builds on
    the CPU, and only a name outside the paper's tasks raises (KeyError,
    as the reference's TASK_MODELS lookup)."""
    for task in ("ic", "sr", "tg", "mlm"):
        kw = {"vocab": 64} if task in ("tg", "mlm") else {}
        params, loss_fn = tpt.make_task_model(task, 0, device="cpu", **kw)
        assert params and callable(loss_fn)
    with pytest.raises(KeyError):
        tpt.make_task_model("asr", 0, device="cpu")
