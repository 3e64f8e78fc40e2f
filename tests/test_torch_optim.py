"""The port's client optimizer against ``repro.optim`` over several steps.

Tolerance rtol 1e-6: both sides do the same f32 elementwise ops in the same
order; the reference's XLA may contract a multiply-add into an FMA.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"stem": (16, 8), "head": (8, 3), "bias": (8,)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _close(a, b):
    for k in SHAPES:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), **TOL)


@pytest.mark.parametrize("momentum,wd", [(0.9, 5e-4), (0.0, 0.0),
                                         (0.9, 0.0), (0.0, 1e-2)])
def test_sgd_tracks_reference_over_steps(momentum, wd):
    jo = jopt.sgd(0.05, momentum=momentum, weight_decay=wd)
    to = topt.sgd(0.05, momentum=momentum, weight_decay=wd)
    jp = jax.tree.map(jax.numpy.asarray, _tree(0))
    tp = _t(_tree(0))
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        g = _tree(100 + step)
        ju, js = jo.update(jax.tree.map(jax.numpy.asarray, g), js, jp)
        tu, ts = to.update(_t(g), ts, tp)
        _close({k: v.numpy() for k, v in tu.items()}, ju)
        jp = jopt.apply_updates(jp, ju)
        tp = topt.apply_updates(tp, tu)
        _close({k: v.numpy() for k, v in tp.items()}, jp)
    if momentum:
        _close({k: v.numpy() for k, v in ts.momentum.items()}, js.momentum)


@pytest.mark.parametrize("scale,max_norm", [(1.0, 0.5), (1e-3, 1.0),
                                            (3.0, 100.0)])
def test_clip_by_global_norm_matches_reference(scale, max_norm):
    g = _tree(7, scale)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jax.numpy.asarray, g),
                                      max_norm)
    tc, tn = topt.clip_by_global_norm(_t(g), max_norm)
    _close({k: v.numpy() for k, v in tc.items()}, jc)
    np.testing.assert_allclose(float(tn), float(jn), **TOL)


def test_clip_per_lane_equals_one_client_at_a_time():
    """batch_dims=1: each lane is clipped by its own norm, as under vmap."""
    lanes = [_tree(20 + i, scale=0.3 * (i + 1)) for i in range(3)]
    stacked = {k: torch.from_numpy(np.stack([t[k] for t in lanes]))
               for k in SHAPES}
    got, norms = topt.clip_by_global_norm(stacked, 1.0, batch_dims=1)
    assert norms.shape == (3,)
    for i, tree in enumerate(lanes):
        want, n = jopt.clip_by_global_norm(
            jax.tree.map(jax.numpy.asarray, tree), 1.0)
        _close({k: v[i].numpy() for k, v in got.items()}, want)
        np.testing.assert_allclose(float(norms[i]), float(n), **TOL)

