"""The port's CUDA kernel and engine on the card.  Every test here is
marked ``cuda`` and skips on a machine without a card; run them there with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

K1 must match its plain version bitwise in f32 (both round each op on its
own) and within one bf16 ulp in bf16.  This file imports only torch, so it
runs where JAX is not installed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fedavg_accum as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

pytestmark = pytest.mark.cuda

SHAPES = [(7,), (33,), (300, 5), (129, 1025), (2, 3, 5, 7), (4096,),
          (512, 512)]
EDGES = [(0.0, 0.0), (0.0, 4.0), (7.0, 0.0), (10.0, 3.0)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.launch.train import set_deterministic
    set_deterministic()
    return torch.device("cuda")


def _rand(shape, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).to(dev)


def _ulps_bf16(a, b):
    ia = a.view(torch.int16).int()
    ib = b.view(torch.int16).int()
    return int((ia - ib).abs().max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_old,n_k", EDGES)
def test_kernel_matches_plain(dev, shape, dtype, n_old, n_k):
    acc, theta = _rand(shape, dtype, dev, 1), _rand(shape, dtype, dev, 2)
    got = tops.fedavg_accum(acc, theta, n_old, n_k)
    want = tref.fedavg_accum_ref(acc, theta, n_old, n_k)
    torch.cuda.synchronize()
    assert got.shape == shape and got.dtype == dtype
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        assert _ulps_bf16(got, want) <= 1


def test_lanes_misaligned_rows_and_counter(dev):
    """[L] weights; rows whose byte length is not a multiple of 16 and a
    base pointer off by one element take the scalar path."""
    tops.reset_launch_counts()
    for n in (7, 4096 + 3):
        base = _rand((4 * n + 1,), torch.float32, dev, 3)
        acc = base[1:].view(4, n)                     # misaligned start
        theta = _rand((4, n), torch.float32, dev, 4)
        n_old = torch.tensor([0.0, 3.0, 7.0, 0.0], device=dev)
        n_k = torch.tensor([0.0, 0.0, 5.0, 2.0], device=dev)
        got = tops.fedavg_accum(acc, theta, n_old, n_k)
        assert torch.equal(got, tref.fedavg_accum_ref(acc, theta, n_old, n_k))
    assert tops.launch_counts() == {"fedavg_accum": 2}


def test_launcher_checks_its_inputs(dev):
    acc = torch.zeros(2, 8, device=dev)
    w = torch.zeros(2, device=dev)
    with pytest.raises(TypeError):
        tfa.fedavg_accum_lanes(acc.double(), acc.double(), w, w)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.fedavg_accum_lanes(acc, torch.zeros(8, 2, device=dev).t(), w, w)
    with pytest.raises(ValueError, match="one device"):
        tfa.fedavg_accum_lanes(acc, acc, w.cpu(), w)


def test_engine_on_card_is_depth_invariant_through_the_kernel(dev):
    from repro_torch.core import (EngineConfig, FederatedEngine,
                                  SyntheticTelemetry, UniformSampler,
                                  make_placement)
    from repro_torch.data import make_federated_dataset
    from repro_torch.distributed import WorkerPool
    from repro_torch.models.papertasks import make_task_model
    from repro_torch.optim import sgd

    ds = make_federated_dataset("sr", n_clients=64, batch_size=4,
                                size_mu=2.5, size_sigma=0.8)

    def run(depth, agg_impl="kernel"):
        params, loss = make_task_model("sr", 0, width=64, n_blocks=2,
                                       device=dev)
        eng = FederatedEngine(
            dataset=ds, loss_fn=loss, init_params=params,
            optimizer=sgd(0.05, momentum=0.9, weight_decay=5e-4),
            placement=make_placement("lb"), sampler=UniformSampler(64, 4),
            pool=WorkerPool.homogeneous(2, type_name="a40", concurrency=2),
            telemetry=SyntheticTelemetry(),
            config=EngineConfig(steps_cap=4, batch_size=4,
                                lanes_per_worker=2, pipeline_depth=depth,
                                agg_impl=agg_impl),
            device=dev)
        tops.reset_launch_counts()
        res = eng.run(4)
        return [r.loss for r in res], sum(r.s_steps for r in res), \
            tops.launch_counts()["fedavg_accum"]

    (l0, s0, k0), (l1, s1, k1), (l2, _, _) = run(0), run(1), run(2)
    assert l0 == l1 == l2
    assert all(np.isfinite(l0))
    assert k0 == s0 and k1 == s1                  # one launch per step
    lp, _, kp = run(1, "plain")
    assert lp == l1 and kp == 0
