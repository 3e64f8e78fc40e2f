"""The port's aggregation functions and fused round step against the JAX
reference, on the same numpy inputs.

Tolerances: the aggregation functions do the reference's f32 elementwise
ops in its order (rtol 1e-6, for XLA's FMA contraction); a round trains
through GEMMs whose sums the two libraries order differently (rtol 1e-5).
The port's own invariants — masked steps, Eq. 1 variants — hold bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_parity as par  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.fl.round import make_round_step as jround  # noqa: E402
from repro.models.papertasks import TASK_MODELS as JTASKS  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.fl import round as tround  # noqa: E402
from repro_torch.models.papertasks import TASK_MODELS  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402

AGG_TOL = dict(rtol=1e-6, atol=1e-7)
ROUND_TOL = dict(rtol=1e-5, atol=1e-6)
IMPLS = [("xla", "plain"), ("pallas", "kernel")]
SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 2, 4)}


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s, dtype=np.float32)
            for k, s in SHAPES.items()}


def _j(tree):
    return jax.tree.map(jax.numpy.asarray, tree)


def _close(got, want, tol=AGG_TOL):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   **tol)


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_partial_update_stream_matches_reference(jimpl, timpl):
    weights = [4.0, 0.0, 7.0, 2.0]
    jp = jagg.partial_init(_j(_tree(0)))
    tp = tagg.partial_init(par.to_torch(_tree(0)))
    for i, w in enumerate(weights):
        theta = _tree(10 + i)
        jp = jagg.partial_update(jp, _j(theta), w, impl=jimpl)
        tp = tagg.partial_update(tp, par.to_torch(theta), w, impl=timpl)
        _close({k: v.numpy() for k, v in tp.theta.items()}, jp.theta)
        assert float(tp.weight) == float(jp.weight)


def test_partial_merge_tree_mean_and_fedavg_flat():
    trees = [_tree(20 + i) for i in range(3)]
    w = [3.0, 5.0, 2.0]
    f32 = jax.numpy.float32
    jm = jagg.partial_merge(jagg.PartialAggregate(_j(trees[0]), f32(3.0)),
                            jagg.PartialAggregate(_j(trees[1]), f32(5.0)))
    tm = tagg.partial_merge(
        tagg.PartialAggregate(par.to_torch(trees[0]), torch.tensor(3.0)),
        tagg.PartialAggregate(par.to_torch(trees[1]), torch.tensor(5.0)))
    _close({k: v.numpy() for k, v in tm.theta.items()}, jm.theta)
    stacked = {k: np.stack([t[k] for t in trees]) for k in SHAPES}
    _close({k: v.numpy() for k, v in tagg.tree_weighted_mean(
        par.to_torch(stacked), w).items()},
        jagg.tree_weighted_mean(_j(stacked), w))
    _close({k: v.numpy() for k, v in tagg.fedavg_flat(
        [par.to_torch(t) for t in trees], w).items()},
        jagg.fedavg_flat([_j(t) for t in trees], w))


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_fold_clients_matches_reference_and_oracle(jimpl, timpl):
    trees = [_tree(30 + i) for i in range(4)]
    w = [2.0, 0.0, 5.0, 3.0]                       # slot 1 is padding
    stacked = {k: np.stack([t[k] for t in trees]) for k in SHAPES}
    jt, jw = jagg.fold_clients(_j(_tree(0)), _j(stacked), np.float32(w),
                               impl=jimpl)
    tt, tw = tagg.fold_clients(par.to_torch(_tree(0)),
                               par.to_torch(stacked), w, impl=timpl)
    _close({k: v.numpy() for k, v in tt.items()}, jt)
    assert float(tw) == float(jw) == sum(w)
    _close(tt, tagg.fedavg_flat([par.to_torch(t) for t in trees], w))


def test_lane_partials_fold_like_separate_partials():
    """A [L] partial weight folds each lane exactly as a scalar partial."""
    lanes = [_tree(40 + i) for i in range(3)]
    stacked = par.to_torch({k: np.stack([t[k] for t in lanes])
                            for k in SHAPES})
    p = tagg.partial_init(stacked, lanes=3)
    p = tagg.partial_update(p, stacked, torch.tensor([2.0, 0.0, 5.0]))
    for i, tree in enumerate(lanes):
        one = tagg.partial_update(
            tagg.partial_init(par.to_torch(tree)), par.to_torch(tree),
            [2.0, 0.0, 5.0][i])
        for k in SHAPES:
            assert torch.equal(p.theta[k][i], one.theta[k])


@pytest.fixture(scope="module")
def round_inputs():
    ds = par.small_dataset()
    return par.ref_params(), par.ref_round_arrays(ds)


def _port_round(params, arr, agg_impl="kernel", grad_clip=None):
    step = tround.make_round_step(
        TASK_MODELS["sr"].loss_fn,
        tsgd(par.LR, momentum=par.MOMENTUM, weight_decay=par.WD),
        agg_impl=agg_impl, grad_clip=grad_clip)
    return step(par.to_torch(params), par.to_torch(arr.batches),
                *(torch.from_numpy(a.copy()) for a in
                  (arr.step_mask, arr.boundary, arr.weight)))


@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_fused_round_matches_reference_pallas(round_inputs, grad_clip):
    """grad_clip 0.5 clips every lane's gradient (their norms are > 1)."""
    params, arr = round_inputs
    step = jax.jit(jround(
        JTASKS["sr"].loss_fn,
        jsgd(par.LR, momentum=par.MOMENTUM, weight_decay=par.WD),
        agg_impl="pallas", grad_clip=grad_clip))
    jnew, jm = step(_j(params), _j(arr.batches), arr.step_mask, arr.boundary,
                    arr.weight)
    tnew, tm = _port_round(params, arr, grad_clip=grad_clip)
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), **ROUND_TOL)
    assert float(tm.steps) == float(jm.steps)
    assert float(tm.clients) == float(jm.clients)
    assert float(tm.total_weight) == float(jm.total_weight)
    _close({k: v.numpy() for k, v in tnew.items()}, jnew, ROUND_TOL)


def test_masked_steps_are_bitwise_no_ops(round_inputs):
    """Padding every lane with trailing masked steps (stale, finite batch
    content) leaves the round's params and loss bit-identical."""
    params, arr = round_inputs
    W, P, S = arr.step_mask.shape
    pad = 3
    rng = np.random.default_rng(7)

    def padded(a, fill):
        extra = fill(a.shape[:2] + (pad,) + a.shape[3:]).astype(a.dtype)
        return np.concatenate([a, extra], axis=2)

    zeros = np.zeros
    long = type(arr)(
        batches={"x": padded(arr.batches["x"], rng.standard_normal),
                 "y": padded(arr.batches["y"],
                             lambda s: rng.integers(0, 35, s))},
        step_mask=padded(arr.step_mask, zeros),
        boundary=padded(arr.boundary, zeros),
        weight=padded(arr.weight, zeros), n_steps=S + pad)
    a_new, a_m = _port_round(params, arr)
    b_new, b_m = _port_round(params, long)
    assert torch.equal(a_m.loss, b_m.loss)
    for k in a_new:
        assert torch.equal(a_new[k], b_new[k]), k


def test_lane_loop_frees_each_folded_partial(round_inputs, monkeypatch):
    """The lane loop keeps no folded partial past its select: when a local
    step's forward and backward run, every partial ``partial_update`` made
    in an earlier step is gone (held, one would add an ``[L, n_g]`` buffer
    per group to the round's peak)."""
    import weakref
    params, arr = round_inputs
    made, alive_at_steps = [], []

    def spy(*a, **k):
        out = tagg.partial_update(*a, **k)
        made.extend(weakref.ref(t) for t in out.theta.values())
        return out

    def loss_fn(p, b):
        alive_at_steps.append(sum(r() is not None for r in made))
        return TASK_MODELS["sr"].loss_fn(p, b)

    monkeypatch.setattr(tround, "partial_update", spy)
    step = tround.make_round_step(
        loss_fn, tsgd(par.LR, momentum=par.MOMENTUM, weight_decay=par.WD))
    step(par.to_torch(params), par.to_torch(arr.batches),
         *(torch.from_numpy(a.copy()) for a in
           (arr.step_mask, arr.boundary, arr.weight)))
    assert len(alive_at_steps) == arr.step_mask.shape[2] > 1
    assert made and alive_at_steps == [0] * len(alive_at_steps)


def test_eq1_variants_agree_bitwise_in_the_round(round_inputs):
    """In the round the fold only counts where N+n > 0, where the kernel
    variant and the plain (XLA) variant compute the same f32 ops."""
    params, arr = round_inputs
    k_new, k_m = _port_round(params, arr, "kernel")
    p_new, p_m = _port_round(params, arr, "plain")
    assert torch.equal(k_m.loss, p_m.loss)
    assert all(torch.equal(k_new[k], p_new[k]) for k in k_new)


def test_step_cache_counts_shapes_and_evicts():
    built = []
    cache = tround.StepCompileCache(lambda: built.append(1) or len(built),
                                    capacity=2)
    for key in [("a",), ("b",), ("a",), ("c",), ("b",)]:
        cache.lookup(key)
    assert cache.stats() == {"compiles": 4, "evictions": 2, "hits": 1,
                             "entries": 2}
    mask = torch.zeros(2, 3, 8)
    key = tround.round_shape_key({"x": torch.zeros(2, 3, 8, 4, 16)}, mask)
    assert key == (2, 3, 8, ("x", (4, 16), "torch.float32"))
