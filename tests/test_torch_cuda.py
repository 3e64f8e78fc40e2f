"""The port's CUDA kernels and engine on the card.  Every test here is
marked ``cuda`` and skips on a machine without a card; run them there with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

K1 and K2 must match their plain versions bitwise in f32 (both round each
op on its own); K1 within one bf16 ulp in bf16.  This file imports only
torch, so it runs where JAX is not installed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dequant_merge as tdm  # noqa: E402
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
    assert tops.launch_counts() == {"fedavg_accum": 2, "dequant_merge": 0}


def test_launcher_checks_its_inputs(dev):
    acc = torch.zeros(2, 8, device=dev)
    w = torch.zeros(2, device=dev)
    with pytest.raises(TypeError):
        tfa.fedavg_accum_lanes(acc.double(), acc.double(), w, w)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.fedavg_accum_lanes(acc, torch.zeros(8, 2, device=dev).t(), w, w)
    with pytest.raises(ValueError, match="one device"):
        tfa.fedavg_accum_lanes(acc, acc, w.cpu(), w)


def _int8(shape, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g,
                         dtype=torch.int8).to(dev)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n_old,n_k", EDGES)
def test_dequant_merge_kernel_matches_plain(dev, shape, n_old, n_k):
    acc, g = _rand(shape, torch.float32, dev, 5), \
        _rand(shape, torch.float32, dev, 6)
    q = _int8(shape, dev, 7)
    got = tops.dequant_merge(acc, q, g, 0.013, n_old, n_k)
    want = tref.dequant_merge_ref(acc, q, g, 0.013, n_old, n_k)
    torch.cuda.synchronize()
    assert got.shape == shape and torch.equal(got, want)
    if n_old + n_k == 0.0:
        assert torch.equal(got, acc)


def test_dequant_merge_ragged_leaves_misaligned_and_counter(dev):
    """Leaves of 7, 0, 33 and 4099 elements (vector units straddle leaf
    edges, one leaf is empty), then the same on buffers that start one
    element off 16-byte alignment (the scalar path)."""
    tops.reset_launch_counts()
    sizes = [7, 0, 33, 4099]
    offsets = torch.tensor([0, 7, 7, 40, 4139], device=dev)
    n = 4139
    scales = torch.tensor([0.5, 0.1, 0.02, 0.003], device=dev)
    for shift in (0, 1):
        acc = _rand((n + 1,), torch.float32, dev, 8)[shift:shift + n]
        g = _rand((n,), torch.float32, dev, 9)
        q = _int8((n + 1,), dev, 10)[shift:shift + n]
        w = torch.tensor([3.0], device=dev), torch.tensor([5.0], device=dev)
        got = tops.dequant_merge_flat(acc, q, g, scales, offsets, *w)
        want = tref.dequant_merge_flat_ref(acc, q, g, scales, offsets, *w)
        assert torch.equal(got, want), sizes
    assert tops.launch_counts()["dequant_merge"] == 2


def test_dequant_merge_launcher_checks_its_inputs(dev):
    acc = torch.zeros(8, device=dev)
    q = torch.zeros(8, dtype=torch.int8, device=dev)
    s = torch.ones(1, device=dev)
    off = torch.tensor([0, 8], device=dev)
    w = torch.zeros(1, device=dev)
    with pytest.raises(TypeError):
        tdm.dequant_merge_flat(acc.double(), q, acc, s, off, w, w)
    with pytest.raises(ValueError, match="int8"):
        tdm.dequant_merge_flat(acc, q.float(), acc, s, off, w, w)
    with pytest.raises(ValueError, match="offsets"):
        tdm.dequant_merge_flat(acc, q, acc, s, off.int(), w, w)
    with pytest.raises(ValueError, match="one device"):
        tdm.dequant_merge_flat(acc, q, acc, s, off, w.cpu(), w)


def test_mesh_engine_on_card_is_depth_invariant_through_k2(dev):
    """The slice's path at a small size: 4 workers over 2 shards, tree
    combine, int8 uploads — losses bitwise across depths, K2 once per
    shard per round, K1 once per worker program step."""
    from repro_torch.core import (EngineConfig, FederatedEngine,
                                  SyntheticTelemetry, UniformSampler,
                                  make_placement)
    from repro_torch.data import make_federated_dataset
    from repro_torch.distributed import WorkerPool
    from repro_torch.models.papertasks import make_task_model
    from repro_torch.optim import sgd

    ds = make_federated_dataset("sr", n_clients=64, batch_size=4,
                                size_mu=2.5, size_sigma=0.8)

    def run(depth, **cfg):
        params, loss = make_task_model("sr", 0, width=64, n_blocks=2,
                                       device=dev)
        eng = FederatedEngine(
            dataset=ds, loss_fn=loss, init_params=params,
            optimizer=sgd(0.05, momentum=0.9, weight_decay=5e-4),
            placement=make_placement("lb"), sampler=UniformSampler(64, 8),
            pool=WorkerPool.homogeneous(4, type_name="a40", concurrency=2),
            telemetry=SyntheticTelemetry(),
            config=EngineConfig(steps_cap=4, batch_size=4,
                                lanes_per_worker=2, pipeline_depth=depth,
                                **cfg),
            device=dev)
        tops.reset_launch_counts()
        res = eng.run(3)
        return [r.loss for r in res], sum(r.s_steps for r in res), \
            tops.launch_counts()

    mesh = dict(mesh_workers=2, combine_mode="tree", combine_compress="int8")
    (l0, s0, k0), (l1, _, k1) = run(0, **mesh), run(1, **mesh)
    assert l0 == l1 and all(np.isfinite(l0))
    assert k0 == k1 == {"fedavg_accum": 4 * s0, "dequant_merge": 2 * 3}
    fused, _, _ = run(1)
    flat, _, _ = run(1, mesh_workers=4)
    assert flat == fused


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
