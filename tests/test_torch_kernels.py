"""K1 (the Eq. 1 fold) of the PyTorch port against the JAX reference.

On the CPU the port's wrapper takes the plain version, which must match
``repro.kernels.ref.fedavg_accum_ref`` bitwise in f32 and the Pallas kernel
(interpret mode, as ``tests/test_kernels.py`` runs it) to rtol 1e-6.  bf16
uses ``tests/test_kernels.py``'s 2e-2.  The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

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
    assert tops.launch_counts() == {"fedavg_accum": 0, "dequant_merge": 0}


def test_wrapper_refuses_other_devices():
    acc = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="no fedavg_accum kernel"):
        tops.fedavg_accum(acc, acc, 1.0, 1.0)
