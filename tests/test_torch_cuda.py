"""The port's CUDA kernels, engine and serve path on the card.  Every test
here is marked ``cuda`` and skips on a machine without a card; run them
there with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

K1 and K2 must match their plain versions bitwise in f32 (both round each
op on its own); K1 within one bf16 ulp in bf16.  K3 and K4 sum in another
order than their plain versions: within ``tests/test_kernels.py``'s 2e-5
in f32 and 2e-2 in bf16.  K5 (the chunked SSD) runs its plain version's
algorithm with the sums in another order: 1e-4 (atol and rtol) in f32 on
outputs up to ~30; in bf16 the f32 results round to bf16, so two sound
versions differ by at most one bf16 step, 2^-7 of the value: rtol 8e-3,
atol 1e-3.  This file imports only torch, so it runs where JAX is not
installed.
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
    assert tops.launch_counts() == {"fedavg_accum": 2, "dequant_merge": 0,
                                    "rmsnorm": 0, "flash_attention": 0, "ssd": 0}


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
    assert k0 == k1 == {"fedavg_accum": 4 * s0, "dequant_merge": 2 * 3,
                        "rmsnorm": 0, "flash_attention": 0, "ssd": 0}
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


# -- K3 and K4 ----------------------------------------------------------------
RMS_SHAPES = [(4, 64), (2, 3, 128), (5, 256), (1, 512), (8192, 1024),
              (4, 2048, 16, 128)]
ATTN = [(2, 128, 4, 2, 32), (1, 100, 8, 8, 16), (2, 260, 6, 2, 64),
        (1, 512, 2, 1, 128), (1, 1000, 16, 8, 128)]


def _close(got, want, dtype):
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= tol + tol * w.abs()).all())


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(dev, shape, dtype):
    x = _rand(shape, dtype, dev, 11)
    scale = _rand(shape[-1:], torch.float32, dev, 12)
    tops.reset_launch_counts()
    got = tops.rmsnorm(x, scale)
    want = tref.rmsnorm_ref(x, scale)
    torch.cuda.synchronize()
    assert tops.launch_counts()["rmsnorm"] == 1
    assert got.shape == x.shape and got.dtype == dtype
    assert _close(got, want, dtype)


def test_rmsnorm_kernel_scalar_path_and_checks(dev):
    """Rows that are no whole number of 16-byte vectors, and a base one
    element off alignment, take the element-by-element path."""
    from repro_torch.kernels import rmsnorm as trn
    for d in (37, 1024):
        base = _rand((5 * d + 1,), torch.float32, dev, 13)
        x = base[1:].view(5, d)
        scale = _rand((d,), torch.float32, dev, 14)
        assert _close(trn.rmsnorm_rows(x, scale, 1e-6),
                      tref.rmsnorm_ref(x, scale), torch.float32)
    x = torch.zeros(4, 8, device=dev)
    with pytest.raises(TypeError):
        trn.rmsnorm_rows(x.double(), torch.ones(8, device=dev), 1e-6)
    with pytest.raises(ValueError, match="scale"):
        trn.rmsnorm_rows(x, torch.ones(8, device=dev).double(), 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        trn.rmsnorm_rows(torch.zeros(8, 4, device=dev).t(),
                         torch.ones(8, device=dev), 1e-6)


@pytest.mark.parametrize("rows,d,dtype", [
    (1, 32, torch.bfloat16), (1, 32, torch.float32),
    (8192, 1024, torch.bfloat16), (8192, 1024, torch.float32)])
def test_rmsnorm_kernel_misaligned_scale(dev, rows, d, dtype):
    """A scale one f32 off a 16-byte boundary (a view into a packed flat
    tree) takes the element path and equals the plain version, as the
    reference's kernel does for any scale."""
    from repro_torch.kernels import rmsnorm as trn
    x = _rand((rows, d), dtype, dev, 37)
    for scale in (torch.ones(d + 1, device=dev)[1:],
                  _rand((d + 1,), torch.float32, dev, 38)[1:]):
        assert scale.data_ptr() % 16 == 4
        assert not trn.vector_ok(x, x, scale)
        tops.reset_launch_counts()
        got = tops.rmsnorm(x, scale)
        torch.cuda.synchronize()
        assert tops.launch_counts()["rmsnorm"] == 1
        assert _close(got, tref.rmsnorm_ref(x, scale), dtype)


@pytest.mark.parametrize("b,s,hq,hkv,d", ATTN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, b, s, hq, hkv, d, dtype):
    q = _rand((b, s, hq, d), dtype, dev, 15)
    k = _rand((b, s, hkv, d), dtype, dev, 16)
    v = _rand((b, s, hkv, d), dtype, dev, 17)
    tops.reset_launch_counts()
    got = tops.flash_attention(q, k, v, causal=True)
    want = tref.flash_attention_bshd_ref(q, k, v, causal=True,
                                         t_pad=tops.padded_kv_len(s))
    torch.cuda.synchronize()
    assert tops.launch_counts()["flash_attention"] == 1
    assert got.shape == q.shape and got.dtype == dtype
    assert _close(got, want, dtype)


@pytest.mark.parametrize("s,t,causal", [(300, 200, True), (64, 200, True),
                                        (256, 256, False)])
def test_flash_attention_kernel_padding_semantics(dev, s, t, causal):
    """Zero keys up to the reference's padded length, seen by causal
    queries at or past ``t``; full attention without padding."""
    q = _rand((2, s, 4, 64), torch.float32, dev, 18)
    k = _rand((2, t, 2, 64), torch.float32, dev, 19)
    v = _rand((2, t, 2, 64), torch.float32, dev, 20)
    got = tops.flash_attention(q, k, v, causal=causal)
    want = tref.flash_attention_bshd_ref(q, k, v, causal=causal,
                                         t_pad=tops.padded_kv_len(t))
    assert _close(got, want, torch.float32)


def test_flash_attention_kernel_reads_strided_inputs(dev):
    """q, k, v as views into a fused qkv buffer (the layout through
    strides, nothing copied) give the same result as contiguous ones."""
    from repro_torch.kernels import flash_attention as tfl
    qkv = _rand((2, 96, 4 + 2 + 2, 32), torch.bfloat16, dev, 21)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    assert not q.is_contiguous()
    got = tfl.flash_attention_bshd(q, k, v, causal=True, t_pad=96)
    want = tfl.flash_attention_bshd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True, t_pad=96)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="head dim"):
        tfl.flash_attention_bshd(q[..., :24], k[..., :24], v[..., :24],
                                 causal=True, t_pad=96)
    with pytest.raises(ValueError, match="dtype"):
        tfl.flash_attention_bshd(q, k.float(), v, causal=True, t_pad=96)
    qt = _rand((2, 96, 32, 4), torch.bfloat16, dev, 25).transpose(2, 3)
    kt = _rand((2, 96, 32, 2), torch.bfloat16, dev, 26).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tfl.flash_attention_bshd(qt, kt, kt, causal=True, t_pad=96)


# bf16 cases of K4's wgmma route (d 64 and 128): ragged s with t < s, GQA
# groups 1, 2 and 8, non-causal, and q/k/v as views of one fused buffer.
WGMMA = [((1, 300, 4, 2, 64), 200, True, False),
         ((1, 300, 4, 2, 128), 200, True, False),
         ((1, 260, 4, 4, 128), 260, True, False),
         ((1, 384, 8, 1, 128), 384, True, False),
         ((2, 256, 4, 2, 64), 256, False, False),
         ((1, 256, 8, 2, 128), 256, False, False),
         ((2, 300, 16, 8, 128), 300, True, True),
         ((2, 200, 6, 2, 64), 200, True, True)]


@pytest.mark.parametrize("shape,t,causal,fused", WGMMA)
def test_flash_attention_wgmma_route_matches_plain(dev, shape, t, causal,
                                                   fused):
    from repro_torch.kernels import flash_attention as tfl
    b, s, hq, hkv, d = shape
    if fused:
        qkv = _rand((b, s, hq + 2 * hkv, d), torch.bfloat16, dev, 27)
        q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    else:
        q = _rand((b, s, hq, d), torch.bfloat16, dev, 28)
        k = _rand((b, t, hkv, d), torch.bfloat16, dev, 29)
        v = _rand((b, t, hkv, d), torch.bfloat16, dev, 30)
    tops.reset_launch_counts()
    got = tops.flash_attention(q, k, v, causal=causal)
    want = tref.flash_attention_bshd_ref(q, k, v, causal=causal,
                                         t_pad=tops.padded_kv_len(t))
    torch.cuda.synchronize()
    assert tfl.ROUTE_LAUNCHES == {"simt": 0, "wgmma": 1}
    assert tops.launch_counts()["flash_attention"] == 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert _close(got, want, torch.bfloat16)


def test_flash_attention_route_by_dtype_and_head_dim_on_card(dev):
    """The library's own route rule equals the wrapper's, and each call
    counts under the route it took: f32 and bf16 at d 16/32 on the SIMT
    kernel, bf16 at d 64/128 on the wgmma kernel."""
    from repro_torch.kernels import flash_attention as tfl
    lib = tfl._lib()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for d in tfl.HEAD_DIMS:
            want = tfl.route(dtype, d)
            assert lib.pollen_flash_attention_route(code, d) == \
                (want == "wgmma")
            q = _rand((1, 64, 2, d), dtype, dev, 31)
            tops.reset_launch_counts()
            tops.flash_attention(q, q[:, :, :1], q[:, :, :1], causal=True)
            torch.cuda.synchronize()
            assert tfl.ROUTE_LAUNCHES[want] == 1
            assert sum(tfl.ROUTE_LAUNCHES.values()) == 1


def test_flash_attention_wgmma_route_refuses_misaligned_strides(dev):
    """A bf16 input whose stride or base TMA cannot address raises, and
    nothing launches: it does not move to the SIMT kernel."""
    from repro_torch.kernels import flash_attention as tfl
    wide = _rand((1, 128, 2, 129), torch.bfloat16, dev, 32)[..., :128]
    ok = _rand((1, 128, 1, 128), torch.bfloat16, dev, 33)
    shifted = _rand((1 * 128 * 2 * 64 + 1,), torch.bfloat16, dev, 34)[1:]
    shifted = shifted.view(1, 128, 2, 64)
    tops.reset_launch_counts()
    with pytest.raises(ValueError, match="stride"):
        tfl.flash_attention_bshd(wide, ok, ok, causal=True, t_pad=128)
    with pytest.raises(ValueError, match="boundary"):
        tfl.flash_attention_bshd(shifted, shifted[:, :, :1],
                                 shifted[:, :, :1], causal=True, t_pad=128)
    assert tfl.LAUNCHES == 0
    assert tfl.ROUTE_LAUNCHES == {"simt": 0, "wgmma": 0}


@pytest.mark.parametrize("rows,d,dtype", [
    (37, 64, torch.bfloat16), (37, 128, torch.bfloat16),
    (1001, 64, torch.float32), (1001, 128, torch.float32),
    (99_999, 128, torch.bfloat16), (3, 1024, torch.bfloat16),
    (5, 96, torch.bfloat16)])
def test_rmsnorm_kernel_sub_warp_rows(dev, rows, d, dtype):
    """Rows shared by a warp (d 64 and 128), rows not a multiple of the
    rows a block takes, and a grid-stride walk longer than the grid; the
    library's geometry equals the wrapper's."""
    import ctypes
    from repro_torch.kernels import rmsnorm as trn
    x = _rand((rows, d), dtype, dev, 35)
    scale = _rand((d,), torch.float32, dev, 36)
    tops.reset_launch_counts()
    got = trn.rmsnorm_rows(x, scale, 1e-6)
    torch.cuda.synchronize()
    assert tops.launch_counts()["rmsnorm"] == 1
    assert _close(got, tref.rmsnorm_ref(x, scale), dtype)
    g = (ctypes.c_int * 3)()
    trn._lib().pollen_rmsnorm_geometry(d, int(dtype == torch.bfloat16), 1, g)
    want = trn.geometry(d, x.element_size(), True)
    assert (trn.PATHS[g[0]], g[1], g[2]) == (
        want["path"], want["lanes_per_row"], want["vectors_per_lane"])


def test_model_routes_launch_k3_and_k4(dev):
    from repro_torch.models.layers import gqa_attention, rms_norm
    q = _rand((2, 64, 4, 32), torch.bfloat16, dev, 22)
    k = _rand((2, 64, 2, 32), torch.bfloat16, dev, 23)
    tops.reset_launch_counts()
    dense = gqa_attention(q, k, k, impl="dense")
    got = gqa_attention(q, k, k, impl="pallas")
    rms_norm(q, torch.ones(32, device=dev), impl="pallas")
    rms_norm(q, torch.ones(32, device=dev))               # the model default
    assert tops.launch_counts()["flash_attention"] == 1
    assert tops.launch_counts()["rmsnorm"] == 1
    assert _close(got, dense, torch.bfloat16)


def test_reduced_serve_path_on_card(dev):
    """The reduced qwen3-0.6b serve path (f32, attn_impl="pallas"): K4 once
    per layer in a prefill and never in decode; prefill + decode equals a
    teacher-forced forward, and the card equals the CPU (1e-4: GEMM sums
    in another order)."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    cfg = replace(get_arch("qwen3-0.6b").reduced(), attn_impl="pallas")
    g = torch.Generator().manual_seed(24)
    toks = torch.randint(0, cfg.vocab_size, (2, 14), generator=g)
    out = {}
    for d in ("cpu", "cuda"):
        params = lm.init_params(0, cfg, device=d)
        tops.reset_launch_counts()
        lg, cache = lm.prefill(params, {"tokens": toks[:, :12]}, cfg,
                               max_len=16, device=d)
        k4_prefill = tops.launch_counts()["flash_attention"]
        steps = [lg]
        for i in range(2):
            lg, cache = lm.decode_step(params, cache, toks[:, 12 + i:13 + i],
                                       12 + i, cfg, device=d)
            steps.append(lg)
        k4_all = tops.launch_counts()["flash_attention"]
        full = lm.forward(params, {"tokens": toks}, cfg, device=d)
        served = torch.stack([x[:, :cfg.vocab_size] for x in steps], 1)
        assert torch.allclose(served, full[:, 11:14], rtol=1e-5, atol=1e-5)
        if d == "cuda":
            assert k4_prefill == k4_all == cfg.n_layers
        out[d] = served.cpu()
    assert torch.allclose(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch,impl", [
    ("granite-moe-3b-a800m", "einsum"), ("granite-moe-3b-a800m", "scatter"),
    ("qwen3-moe-235b-a22b", "scatter"), ("jamba-v0.1-52b", "scatter")])
def test_reduced_moe_serve_paths_on_card(dev, arch, impl):
    """A reduced MoE arch's serve path (f32, through K4, and K5 for jamba):
    prefill + 2 decode steps equal a dropless teacher-forced forward, and
    the card's prefill and decode logits at capacity factor 1.25 equal the
    CPU's (1e-4: GEMM sums in another order)."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    base = replace(get_arch(arch).reduced(), attn_impl="pallas",
                   ssd_impl="pallas", moe_impl=impl)
    dropless = replace(base, capacity_factor=base.n_experts / base.top_k)
    g = torch.Generator().manual_seed(25)
    toks = torch.randint(0, base.vocab_size, (2, 14), generator=g)
    out = {}
    for d in ("cpu", "cuda"):
        params = lm.init_params(0, base, device=d)
        for cfg in (base, dropless):
            lg, cache = lm.prefill(params, {"tokens": toks[:, :12]}, cfg,
                                   max_len=16, device=d)
            steps = [lg]
            for i in range(2):
                lg, cache = lm.decode_step(params, cache,
                                           toks[:, 12 + i:13 + i], 12 + i,
                                           cfg, device=d)
                steps.append(lg)
            served = torch.stack([x[:, :cfg.vocab_size] for x in steps], 1)
            out[d, cfg.capacity_factor] = served.cpu()
        full = lm.forward(params, {"tokens": toks}, dropless, device=d)
        assert torch.allclose(out[d, dropless.capacity_factor],
                              full[:, 11:14].cpu(), rtol=1e-5, atol=1e-5)
    assert torch.allclose(out["cuda", base.capacity_factor],
                          out["cpu", base.capacity_factor], rtol=1e-4,
                          atol=1e-4)


@pytest.mark.parametrize("arch,impl", [("whisper-base", "dense"),
                                       ("internvl2-26b", "pallas")])
def test_reduced_frontend_serve_paths_on_card(dev, arch, impl):
    """whisper (encoder, cross-attention, learned positions) and internvl2
    (patches in front of the text, through K4) at ``reduced()`` in f32:
    prefill + 2 decode steps equal the teacher-forced forward at the
    patch-shifted positions, K4 runs once per layer in internvl2's prefill
    and never in decode, and the card equals the CPU (1e-4: GEMM sums in
    another order).  whisper through K4 raises before any launch (its
    non-causal encoder's 16 keys would be padded)."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    cfg = replace(get_arch(arch).reduced(), attn_impl=impl)
    g = torch.Generator().manual_seed(26)
    toks = torch.randint(0, cfg.vocab_size, (2, 14), generator=g)
    width = cfg.resolved_frontend_dim if cfg.frontend == "patch" \
        else cfg.d_model
    stub = torch.randn(2, cfg.frontend_len, width, generator=g)
    key = "patch_embed" if cfg.frontend == "patch" else "frames"
    off = cfg.frontend_len if cfg.frontend == "patch" else 0
    out = {}
    for d in ("cpu", "cuda"):
        params = lm.init_params(0, cfg, device=d)
        tops.reset_launch_counts()
        lg, cache = lm.prefill(params, {"tokens": toks[:, :12], key: stub},
                               cfg, max_len=off + 16, device=d)
        k4_prefill = tops.launch_counts()["flash_attention"]
        steps = [lg]
        for i in range(2):
            lg, cache = lm.decode_step(params, cache, toks[:, 12 + i:13 + i],
                                       off + 12 + i, cfg, device=d)
            steps.append(lg)
        k4_all = tops.launch_counts()["flash_attention"]
        full = lm.forward(params, {"tokens": toks, key: stub}, cfg, device=d)
        served = torch.stack([x[:, :cfg.vocab_size] for x in steps], 1)
        assert torch.allclose(served, full[:, off + 11:off + 14],
                              rtol=1e-5, atol=1e-5)
        if d == "cuda":
            want = cfg.n_layers if impl == "pallas" else 0
            assert k4_prefill == k4_all == want
        out[d] = served.cpu()
    assert torch.allclose(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)
    if arch == "whisper-base":
        tops.reset_launch_counts()
        with pytest.raises(NotImplementedError, match="non-causal padding"):
            lm.prefill(params, {"tokens": toks, key: stub},
                       replace(cfg, attn_impl="pallas"), device="cuda")
        assert tops.launch_counts()["flash_attention"] == 0


def test_moe_scatter_dispatch_is_deterministic_on_card(dev):
    """The scatter dispatch's accumulating scatter into the overflow row
    and its gather's backward: the same outputs and gradients bit for bit
    on a second run, and the einsum impl's values within 1e-5 of each
    tensor's largest magnitude (the gradients reach ~5e3: 200 copies of
    one token share its expert rows)."""
    from repro_torch.models.layers import _moe_dispatch
    T, D, E, F, k = 300, 64, 8, 32, 2
    x = _rand((T, D), torch.float32, dev, 26)
    x[100:] = x[99]                       # fill one expert past capacity
    ws = [_rand(s, torch.float32, dev, 27 + i) * 0.2 for i, s in
          enumerate([(D, E), (E, D, F), (E, D, F), (E, F, D)])]
    runs = []
    for impl in ("scatter", "scatter", "einsum"):
        leaves = [w.clone().requires_grad_() for w in ws]
        out, aux = _moe_dispatch(x, *leaves, top_k=k, impl=impl)
        (out.square().sum() + aux).backward()
        runs.append([out.detach(), aux.detach()]
                    + [w.grad for w in leaves])
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    for a, b in zip(runs[0], runs[2]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_lm_head_writes_f32_logits_from_bf16_on_card(dev):
    """On the card the head multiplies bf16 operands straight into f32
    (cuBLAS ``out_dtype``): equal to the upcast f32 product up to the
    order of the f32 sums (1e-4), far inside one bf16 rounding (~4e-3)."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    cfg = replace(get_arch("qwen3-0.6b").reduced(), dtype="bfloat16")
    params = lm.init_params(0, cfg, device="cuda")
    h = _rand((2, 3, cfg.d_model), torch.bfloat16, dev, 25)
    got = lm._lm_head(params, h, cfg)
    want = h.float() @ params["embed"].T.float()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_f32_logits_backward_tracks_the_f32_product_on_card(dev):
    """The card's LM head backward (``_F32Logits``) rounds the f32 logit
    gradient to bf16 and writes each product's result in bf16: against
    the gradients of the f32 product ``h.float() @ w.float()`` each is
    within 2^-7 in relative norm (one bf16 rounding of the gradient and
    one of the result, ~2^-9 each); a transposed, dropped or mis-scaled
    gradient is off by ~1."""
    from repro_torch.models import lm
    h = _rand((96, 64), torch.bfloat16, dev, 31).requires_grad_()
    w = _rand((64, 200), torch.bfloat16, dev, 32).requires_grad_()
    g = _rand((96, 200), torch.float32, dev, 33)
    out = lm._F32Logits.apply(h, w)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, (h, w), g)
    hf, wf = (x.detach().float().requires_grad_() for x in (h, w))
    want = torch.autograd.grad(hf @ wf, (hf, wf), g)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert float((a.float() - b).norm() / b.norm()) <= 2.0 ** -7


# One bf16 round against another sound bf16 implementation: each dtype
# group's update (new minus initial params) within this share of the
# other's in relative norm.  tests/test_torch_mixed_dtype.py holds the port
# to the reference on the CPU by the same measure.
BF16_UPDATE_RTOL = 0.1


def _group_update_rel(new, want, init):
    """``||Δnew − Δwant|| / ||Δwant||`` by dtype group, Δ from ``init``."""
    num, den = {}, {}
    for k, w in want.items():
        key = str(w.dtype)
        d = want[k].float() - init[k].float()
        num[key] = num.get(key, 0.0) + float(
            (new[k].float() - want[k].float()).square().sum())
        den[key] = den.get(key, 0.0) + float(d.square().sum())
    return {k: (num[k] / den[k]) ** 0.5 for k in den}


def test_bf16_lm_round_on_card_tracks_the_cpu(dev):
    """Two rounds of reduced qwen3 in bf16 on the card (the LM head through
    ``_F32Logits``, K1 once per dtype group a lane-loop step) against the
    same on the CPU: losses within rtol 1e-3, each dtype group's update
    within ``BF16_UPDATE_RTOL``, where unchanged params are off by 1."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.kernels.layout import flatten_tree
    from repro_torch.launch.train import build_engine
    cfg = replace(get_arch("qwen3-0.6b").reduced(), dtype="bfloat16")
    runs = {}
    for device in ("cuda", "cpu"):
        eng = build_engine(lm_cfg=cfg, device=device, cohort=4, steps_cap=2)
        init = {k: v.cpu().clone()
                for k, v in flatten_tree(eng.params).items()}
        tops.reset_launch_counts()
        res = eng.run(2)
        launches = tops.launch_counts()["fedavg_accum"]
        final = {k: v.cpu() for k, v in flatten_tree(eng.params).items()}
        runs[device] = ([r.loss for r in res], init, final)
        if device == "cuda":
            torch.cuda.synchronize()
            assert launches == 2 * sum(r.s_steps for r in res)
    (card, card_init, card_params), (cpu, init, cpu_params) = (
        runs["cuda"], runs["cpu"])
    assert all(torch.equal(card_init[k], v) for k, v in init.items())
    assert {v.dtype for v in cpu_params.values()} == {torch.bfloat16,
                                                       torch.float32}
    np.testing.assert_allclose(card, cpu, rtol=1e-3)
    rel = _group_update_rel(card_params, cpu_params, init)
    assert len(rel) == 2 and max(rel.values()) <= BF16_UPDATE_RTOL, rel
    assert min(_group_update_rel(init, cpu_params, init).values()) == 1.0


# The mesh path of a bf16 config: 4 workers of 2 lanes over 2 shards, tree
# combine, int8 uploads.
BF16_MESH = dict(workers=4, mesh_workers=2, combine_mode="tree",
                 combine_compress="int8")


def test_bf16_int8_mesh_on_card_tracks_the_cpu(dev):
    """Two rounds of reduced qwen3 in bf16 on the tree + int8 mesh on the
    card against the same on the CPU, by the bounds of the fused bf16 test
    above: losses within rtol 1e-3, each dtype group's update within
    ``BF16_UPDATE_RTOL``; on the card K1 folds each dtype group once per
    worker-program step and K2 runs once per shard a round, over the f32
    twin of both groups."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.kernels.layout import flatten_tree
    from repro_torch.launch.train import build_engine
    cfg = replace(get_arch("qwen3-0.6b").reduced(), dtype="bfloat16")
    runs = {}
    for device in ("cuda", "cpu"):
        eng = build_engine(lm_cfg=cfg, device=device, cohort=4, steps_cap=2,
                           **BF16_MESH)
        init = {k: v.cpu().clone()
                for k, v in flatten_tree(eng.params).items()}
        tops.reset_launch_counts()
        res = eng.run(2)
        launches = tops.launch_counts()
        final = {k: v.cpu() for k, v in flatten_tree(eng.params).items()}
        runs[device] = ([r.loss for r in res], init, final)
        if device == "cuda":
            torch.cuda.synchronize()
            steps = BF16_MESH["workers"] * sum(r.s_steps for r in res)
            assert launches["fedavg_accum"] == 2 * steps
            assert launches["dequant_merge"] == 2 * 2
    (card, _, card_params), (cpu, init, cpu_params) = (runs["cuda"],
                                                       runs["cpu"])
    assert {v.dtype for v in card_params.values()} == {torch.bfloat16,
                                                        torch.float32}
    np.testing.assert_allclose(card, cpu, rtol=1e-3)
    rel = _group_update_rel(card_params, cpu_params, init)
    assert len(rel) == 2 and max(rel.values()) <= BF16_UPDATE_RTOL, rel


def _mixed_layout():
    """The layout of reduced qwen3 in bf16 (bf16 matrices, f32 norms)."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.kernels.layout import FlatLayout, flatten_tree
    from repro_torch.models import lm
    cfg = replace(get_arch("qwen3-0.6b").reduced(), dtype="bfloat16")
    return FlatLayout(flatten_tree(lm.init_params(0, cfg, device="cpu")))


def test_fedmedian_mixed_tree_on_card(dev):
    """The median of each dtype group, in its dtype, is bitwise the CPU's
    on 4 and 5 lanes, with a NaN, ±inf and an all-inf column in each
    group; a FedMedian engine on the bf16 config trains on the card with
    no kernel launched and keeps both dtypes."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.fl.strategy import FedMedian
    from repro_torch.kernels.layout import flatten_tree
    from repro_torch.launch.train import build_engine
    layout = _mixed_layout()
    for lanes in (4, 5):
        stacked = {}
        for i, (key, g) in enumerate(zip(layout.keys, layout.groups)):
            x = _rand((lanes, g.n), g.dtypes[0], "cpu", 50 + i + lanes)
            x[1, 0], x[0, 1], x[2, 2] = (float("nan"), float("inf"),
                                         float("-inf"))
            x[:, 3] = float("inf")
            stacked[key] = x
        glob = {k: v[0].clone() for k, v in stacked.items()}
        want = FedMedian().reduce(stacked, None, glob)
        got = FedMedian().reduce({k: v.to(dev) for k, v in stacked.items()},
                                 None, {k: v.to(dev) for k, v in
                                        glob.items()})
        for k, w in want.items():
            assert got[k].dtype == w.dtype == glob[k].dtype
            g = got[k].cpu()
            assert torch.equal(torch.isnan(g), torch.isnan(w)), k
            assert torch.isnan(w[0]) and torch.equal(g[1:4], w[1:4])
            finite = ~torch.isnan(w)
            assert torch.equal(g[finite], w[finite]), k
    cfg = replace(get_arch("qwen3-0.6b").reduced(), dtype="bfloat16")
    eng = build_engine(lm_cfg=cfg, device="cuda", cohort=4, steps_cap=2,
                       strategy="fedmedian")
    tops.reset_launch_counts()
    losses = [r.loss for r in eng.run(2)]
    torch.cuda.synchronize()
    assert all(np.isfinite(losses))
    assert sum(tops.launch_counts().values()) == 0
    assert {v.dtype for v in flatten_tree(eng.params).values()} == {
        torch.bfloat16, torch.float32}


def test_k2_on_a_mixed_trees_f32_twin_on_card(dev):
    """K2 over the f32 twin of a mixed tree (every leaf of both dtypes, one
    scale a leaf) against its plain version, bitwise at the weight edges;
    the int8 compressed combine step on the card bitwise the CPU's, one K2
    launch a shard, its result in each leaf's dtype."""
    import repro_torch.core  # noqa: F401 (loads fl.round through the engine)
    from repro_torch.compress import make_encode_step
    from repro_torch.fl.round import make_compressed_combine_step
    from repro_torch.kernels.layout import tree_stack
    layout = _mixed_layout()
    twin = layout.twin
    assert not twin.mixed and twin.names == layout.names

    def tree(seed, scale=1.0):
        return layout.views({key: _rand((g.n,), g.dtypes[0], "cpu", seed + i)
                             * scale for i, (key, g) in
                             enumerate(zip(layout.keys, layout.groups))})

    g = tree(60)
    theta = layout.views({k: (f.float() + tree(62, 0.01).flats[k].float())
                          .to(f.dtype) for k, f in g.flats.items()})
    encode = make_encode_step("int8", 0.05)
    pays = [encode(g, theta, twin.views(
        _rand((twin.n,), torch.float32, "cpu", 64 + s) * 1e-3))[0]
        for s in range(2)]
    q, scales = pays[0]
    gf = layout.to_twin(g).to(dev)
    acc = _rand((twin.n,), torch.float32, dev, 66)
    offsets = twin.offsets_on(dev)
    for n_old, n_k in EDGES:
        args = (acc, q.flat.to(dev), gf, scales.flat.to(dev), offsets,
                torch.tensor(n_old, device=dev),
                torch.tensor(n_k, device=dev))
        tops.reset_launch_counts()
        got = tops.dequant_merge_flat(*args)
        torch.cuda.synchronize()
        assert tops.launch_counts()["dequant_merge"] == 1
        assert torch.equal(got, tref.dequant_merge_flat_ref(*args))
    payload = (tree_stack([p[0] for p in pays]),
               tree_stack([p[1] for p in pays]))
    n = torch.tensor([4.0, 6.0])
    ls = torch.tensor([0.5, 1.25])
    masks = [torch.ones(2, 2, 3)] * 3
    combine = make_compressed_combine_step("int8")
    want, _ = combine(g, payload, n, ls, *masks)
    tops.reset_launch_counts()
    got, _ = combine(g.map(lambda f: f.to(dev)),
                     tuple(t.map(lambda f: f.to(dev)) for t in payload),
                     n.to(dev), ls.to(dev), *(m.to(dev) for m in masks))
    torch.cuda.synchronize()
    assert tops.launch_counts()["dequant_merge"] == 2
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k].cpu(), w), k


# -- K5 -----------------------------------------------------------------------
# (b, s, h, p, g, n, chunk): tests/test_kernels.py's sweep; s = 100 at the
# wrapper's own chunk (round_up(100, 8) = 104, no multiple of 16); a ragged
# prompt and the serve shape at mamba2-2.7b's widths.
SSD = [(2, 64, 4, 16, 2, 32, 16), (1, 100, 8, 32, 1, 64, 32),
       (2, 128, 4, 64, 4, 16, 128), (1, 100, 8, 32, 1, 64, 128),
       (1, 1000, 80, 64, 1, 128, 128), (4, 2048, 80, 64, 1, 128, 128)]
SSD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
           torch.bfloat16: dict(rtol=8e-3, atol=1e-3)}


def _ssd_inputs(b, s, h, p, g, n, dtype, dev, seed):
    """The sweep's draws (dt = softplus(normal), A_log and D scaled by 0.3
    and 0.1, B and C by 0.5), in the model layout on the card."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=gen)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, generator=gen))
    A_log = torch.randn(h, generator=gen) * 0.3
    B = torch.randn(b, s, g, n, generator=gen) * 0.5
    C = torch.randn(b, s, g, n, generator=gen) * 0.5
    D = torch.randn(h, generator=gen) * 0.1
    return (x.to(dtype).to(dev), dt.to(dev), A_log.to(dev),
            B.to(dtype).to(dev), C.to(dtype).to(dev), D.to(dev))


def _ssd_model_inputs(b, s, h, p, g, n, dtype, dev, seed):
    """The mixer's magnitudes at mamba2-2.7b's widths (chip_smoke.py's
    model-like draws): dt = softplus(normal/2 + the init's dt_bias row),
    A_log = log(linspace(1, 16, h)), D = 1, x of SiLU-sized magnitude."""
    import math
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=gen) * 0.5
    B = torch.randn(b, s, g, n, generator=gen) * 0.5
    C = torch.randn(b, s, g, n, generator=gen) * 0.5
    dt_bias = torch.log(torch.expm1(torch.exp(torch.linspace(
        math.log(1e-3), math.log(1e-1), h))))
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen) * 0.5 + dt_bias)
    A_log = torch.log(torch.linspace(1.0, 16.0, h))
    return (x.to(dtype).to(dev), dt.to(dev), A_log.to(dev),
            B.to(dtype).to(dev), C.to(dtype).to(dev), torch.ones(h).to(dev))


def _close_tol(got, want, rtol, atol):
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


@pytest.mark.parametrize("b,s,h,p,g,n,ck", SSD)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(dev, b, s, h, p, g, n, ck, dtype):
    """y and the final state against the plain chunk loop."""
    args = _ssd_inputs(b, s, h, p, g, n, dtype, dev, 31)
    tops.reset_launch_counts()
    y, state = tops.ssd(*args, chunk=ck, return_state=True)
    torch.cuda.synchronize()
    assert tops.launch_counts()["ssd"] == 1
    want_y, want_state = tref.ssd_chunks_ref(*args,
                                             chunk=tops.ssd_chunk(s, ck))
    assert y.shape == (b, s, h, p) and y.dtype == dtype
    assert state.shape == (b, h, p, n) and state.dtype == torch.float32
    assert _close_tol(y, want_y, **SSD_TOL[dtype])
    assert _close_tol(state, want_state, **SSD_TOL[torch.float32])
    assert torch.equal(tops.ssd(*args, chunk=ck), y)   # without the state


def test_ssd_kernel_reads_strided_inputs(dev):
    """x, B and C as views into one conv-output buffer, as the mixer hands
    them over (nothing copied), equal the contiguous ones; the wrapper
    refuses what the kernel does not take."""
    from repro_torch.kernels import ssd as tssd
    b, s, h, p, g, n = 2, 70, 4, 32, 2, 16
    xbc = _rand((b, s, h * p + 2 * g * n), torch.bfloat16, dev, 32)
    x = xbc[..., :h * p].view(b, s, h, p)
    B = xbc[..., h * p:h * p + g * n].view(b, s, g, n)
    C = xbc[..., h * p + g * n:].view(b, s, g, n)
    assert not x.is_contiguous()
    _, dt, A_log, _, _, D = _ssd_inputs(b, s, h, p, g, n, torch.bfloat16,
                                        dev, 33)
    got = tssd.ssd_bshp(x, dt, A_log, B, C, D, chunk=32, want_state=True)
    want = tssd.ssd_bshp(x.contiguous(), dt, A_log, B.contiguous(),
                         C.contiguous(), D, chunk=32, want_state=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="f32"):
        tssd.ssd_bshp(x, dt.bfloat16(), A_log, B, C, D, chunk=32)
    with pytest.raises(ValueError, match="out of range"):
        tssd.ssd_bshp(x, dt, A_log, B, C, D, chunk=256)
    with pytest.raises(ValueError, match="dtype"):
        tssd.ssd_bshp(x, dt, A_log, B.float(), C, D, chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        tssd.ssd_bshp(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                      A_log, B, C, D, chunk=32)


# K5's wgmma route (bf16 at p 64): the sweep's p-64 case, a chunk of 32
# padded to 128 rows, GQA groups, a prompt shorter than one chunk, the
# ragged prompt and the serve shape at mamba2-2.7b's widths, jamba's n 16,
# and an n of 40 (zero-padded to 64 columns) at chunk 16.
SSD_WGMMA = [(2, 128, 4, 64, 4, 16, 128), (1, 100, 8, 64, 1, 128, 32),
             (2, 300, 4, 64, 2, 64, 128), (1, 50, 4, 64, 1, 128, 128),
             (1, 1000, 80, 64, 1, 128, 128), (4, 2048, 80, 64, 1, 128, 128),
             (2, 512, 8, 64, 1, 16, 128), (1, 70, 3, 64, 1, 40, 16)]


@pytest.mark.parametrize("b,s,h,p,g,n,ck", SSD + SSD_WGMMA)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_routes_match_plain(dev, b, s, h, p, g, n, ck, dtype):
    """Each case launches the route its dtype and widths name (read from
    ROUTE_LAUNCHES), within the tolerances against the plain chunk loop;
    without the state it gives the same y.  At mamba2-2.7b's widths (80
    heads) the inputs have the mixer's magnitudes, as on the serve path."""
    from repro_torch.kernels import ssd as tssd
    draw = _ssd_model_inputs if h == 80 else _ssd_inputs
    args = draw(b, s, h, p, g, n, dtype, dev, 39)
    want_route = tssd.route(dtype, p, n, ck)
    tops.reset_launch_counts()
    y, state = tops.ssd(*args, chunk=ck, return_state=True)
    torch.cuda.synchronize()
    assert tssd.ROUTE_LAUNCHES == {"simt": 0, "wgmma": 0, want_route: 1}
    want_y, want_state = tref.ssd_chunks_ref(*args,
                                             chunk=tops.ssd_chunk(s, ck))
    assert _close_tol(y, want_y, **SSD_TOL[dtype])
    assert _close_tol(state, want_state, **SSD_TOL[torch.float32])
    assert torch.equal(tops.ssd(*args, chunk=ck), y)
    assert tssd.ROUTE_LAUNCHES[want_route] == 2


def test_ssd_route_by_dtype_and_widths_on_card(dev):
    """The library's own route rule equals the wrapper's."""
    from repro_torch.kernels import ssd as tssd
    lib = tssd._lib()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for p, n in ((16, 32), (32, 64), (64, 16), (64, 40), (64, 128),
                     (64, 12)):
            for ck in (16, 104, 128):
                assert lib.pollen_ssd_route(code, p, n, ck) == \
                    (tssd.route(dtype, p, n, ck) == "wgmma")


def test_ssd_wgmma_route_reads_strided_inputs(dev):
    """On the wgmma route, x, B and C as views into one conv-output buffer
    (the mixer's layout) equal the contiguous ones, bit for bit."""
    from repro_torch.kernels import ssd as tssd
    b, s, h, p, g, n = 2, 150, 4, 64, 1, 128
    xbc = _rand((b, s, h * p + 2 * g * n), torch.bfloat16, dev, 40)
    x = xbc[..., :h * p].view(b, s, h, p)
    B = xbc[..., h * p:h * p + g * n].view(b, s, g, n)
    C = xbc[..., h * p + g * n:].view(b, s, g, n)
    assert not x.is_contiguous()
    _, dt, A_log, _, _, D = _ssd_inputs(b, s, h, p, g, n, torch.bfloat16,
                                        dev, 41)
    tops.reset_launch_counts()
    got = tssd.ssd_bshp(x, dt, A_log, B, C, D, chunk=128, want_state=True)
    want = tssd.ssd_bshp(x.contiguous(), dt, A_log, B.contiguous(),
                         C.contiguous(), D, chunk=128, want_state=True)
    torch.cuda.synchronize()
    assert tssd.ROUTE_LAUNCHES == {"simt": 0, "wgmma": 2}
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ssd_wgmma_route_refuses_misaligned_strides(dev):
    """A bf16 input whose base or stride the 16-byte copies cannot address
    raises, and nothing launches: it does not move to the SIMT kernel."""
    from repro_torch.kernels import ssd as tssd
    b, s, h, p, g, n = 1, 64, 2, 64, 1, 16
    x, dt, A_log, B, C, D = _ssd_inputs(b, s, h, p, g, n, torch.bfloat16,
                                        dev, 42)
    wide = _rand((b, s, h * p + 4), torch.bfloat16, dev, 43)
    x_wide = wide[..., :h * p].view(b, s, h, p)      # row stride 264 bf16
    shifted = _rand((b * s * h * p + 1,), torch.bfloat16, dev, 44)[1:]
    x_shifted = shifted.view(b, s, h, p)             # base 2 bytes off
    tops.reset_launch_counts()
    with pytest.raises(ValueError, match="stride"):
        tssd.ssd_bshp(x_wide, dt, A_log, B, C, D, chunk=64)
    with pytest.raises(ValueError, match="boundary"):
        tssd.ssd_bshp(x_shifted, dt, A_log, B, C, D, chunk=64)
    assert tssd.LAUNCHES == 0
    assert tssd.ROUTE_LAUNCHES == {"simt": 0, "wgmma": 0}


def test_mamba_mixer_routes_launch_k5(dev):
    """impl="pallas" launches K5 once a call and agrees with "chunked"."""
    from repro_torch.models.ssd import mamba2_mixer
    g = torch.Generator().manual_seed(34)
    d, di, hd, ng, n = 64, 128, 16, 1, 16
    h = di // hd
    p = {"mamba_in": torch.randn(d, 2 * di + 2 * ng * n + h, generator=g)
         / d ** 0.5, "mamba_conv": torch.randn(4, di + 2 * ng * n,
                                               generator=g) * 0.5,
         "mamba_A": torch.log(torch.linspace(1, 16, h)),
         "mamba_dt_bias": torch.full((h,), -2.0), "mamba_D": torch.ones(h),
         "mamba_gnorm": torch.ones(di),
         "mamba_out": torch.randn(di, d, generator=g) / di ** 0.5}
    p = {k: v.to(dev) for k, v in p.items()}
    x = _rand((2, 50, d), torch.float32, dev, 35)
    kw = dict(head_dim=hd, n_groups=ng, d_state=n, chunk=16,
              return_state=True)
    tops.reset_launch_counts()
    out, (tail, st) = mamba2_mixer(p, x, impl="pallas", **kw)
    assert tops.launch_counts()["ssd"] == 1
    want, (wtail, wst) = mamba2_mixer(p, x, impl="chunked", **kw)
    assert torch.allclose(out, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(tail, wtail)
    assert torch.allclose(st, wst, rtol=1e-4, atol=1e-4)


def test_reduced_mamba_serve_path_on_card(dev):
    """The reduced mamba2-2.7b serve path (f32, ssd_impl="pallas"): K5 once
    per layer in a prefill and never in decode; prefill + decode equals a
    teacher-forced forward, and the card equals the CPU (1e-4: GEMM sums in
    another order)."""
    from dataclasses import replace
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    cfg = replace(get_arch("mamba2-2.7b").reduced(), ssd_impl="pallas")
    g = torch.Generator().manual_seed(36)
    toks = torch.randint(0, cfg.vocab_size, (2, 14), generator=g)
    out = {}
    for d in ("cpu", "cuda"):
        params = lm.init_params(0, cfg, device=d)
        tops.reset_launch_counts()
        lg, cache = lm.prefill(params, {"tokens": toks[:, :12]}, cfg,
                               max_len=16, device=d)
        k5_prefill = tops.launch_counts()["ssd"]
        steps = [lg]
        for i in range(2):
            lg, cache = lm.decode_step(params, cache, toks[:, 12 + i:13 + i],
                                       12 + i, cfg, device=d)
            steps.append(lg)
        k5_all = tops.launch_counts()["ssd"]
        full = lm.forward(params, {"tokens": toks}, cfg, device=d)
        served = torch.stack([x[:, :cfg.vocab_size] for x in steps], 1)
        assert torch.allclose(served, full[:, 11:14], rtol=1e-5, atol=1e-5)
        if d == "cuda":
            assert k5_prefill == k5_all == cfg.n_layers
        out[d] = (served.cpu(), cache["p0"]["ssm"].cpu())
    assert torch.allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                          atol=1e-4)
    assert torch.allclose(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                          atol=1e-4)


# -- federated LM training (--arch) -------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-2.7b",
                                  "granite-moe-3b-a800m", "whisper-base",
                                  "internvl2-26b"])
def test_lm_rounds_on_card_track_the_cpu(dev, arch):
    """Two rounds of a reduced arch's federated training on the card
    against the same on the CPU: losses within rtol 1e-6 and the final
    params leaf by leaf within rtol 1e-4 + atol 1e-6 (GEMM sums in another
    order), where the initial params fall outside that tolerance; and
    bit-identical across pipeline depths on the card."""
    from repro_torch.kernels.layout import flatten_tree
    from repro_torch.launch.train import build_engine

    def run(device, depth=1):
        eng = build_engine(arch=arch, device=device, cohort=4, steps_cap=2,
                           pipeline_depth=depth, population=64)
        init = {k: v.cpu().clone()
                for k, v in flatten_tree(eng.params).items()}
        losses = [r.loss for r in eng.run(2)]
        final = {k: v.cpu() for k, v in flatten_tree(eng.params).items()}
        return losses, init, final

    card, _, card_params = run("cuda")
    cpu, init, cpu_params = run("cpu")
    np.testing.assert_allclose(card, cpu, rtol=1e-6)
    assert set(card_params) == set(cpu_params)
    for k, v in cpu_params.items():
        assert torch.allclose(card_params[k], v, rtol=1e-4, atol=1e-6), k
    assert not all(torch.allclose(init[k], v, rtol=1e-4, atol=1e-6)
                   for k, v in cpu_params.items())
    assert run("cuda", depth=0)[0] == card


def test_k1_launches_once_per_lm_lane_step(dev):
    """The LM round folds every lane's flat params with one K1 launch a
    local step, fused and on each mesh worker's program."""
    from repro_torch.launch.train import build_engine
    for mesh in (0, 2):
        eng = build_engine(arch="qwen3-0.6b", device="cuda", cohort=4,
                           steps_cap=2, population=64, mesh_workers=mesh)
        tops.reset_launch_counts()
        res = eng.run(2)
        torch.cuda.synchronize()
        programs = 2 if mesh else 1               # 2 workers
        assert tops.launch_counts()["fedavg_accum"] == \
            programs * sum(r.s_steps for r in res)


# -- the paper's other tasks, FedMedian and resume (--task, --strategy,
# --ckpt-dir) ---------------------------------------------------------------
TASK_SMALL = {"ic": dict(width=32, n_blocks=2),
              "tg": dict(vocab=90, hidden=16),
              "mlm": dict(vocab=512, d_model=32, n_layers=2, d_ff=64)}


def _task_engine(task, device, *, depth=1, strategy="fedavg", ckpt=None,
                 **cfg):
    """A reduced task engine (cohort 8 over 2 workers x 2 lanes,
    ``steps_cap`` 2) with the reference's per-task optimizer, its weights
    drawn on the CPU from seed 0 and moved to ``device``."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.core import (EngineConfig, FederatedEngine,
                                  SyntheticTelemetry, UniformSampler,
                                  make_placement)
    from repro_torch.data import make_federated_dataset
    from repro_torch.distributed import WorkerPool
    from repro_torch.fl.strategy import strategy_from_name
    from repro_torch.models.papertasks import make_task_model
    from repro_torch.optim import adam, sgd
    small = TASK_SMALL.get(task, dict(input_dim=16, width=32, n_blocks=2))
    extra = ({"vocab_size": small["vocab"], "seq_len": 12}
             if task in ("tg", "mlm") else
             {"input_dim": 16} if task == "sr" else {})
    ds = make_federated_dataset(task, n_clients=64, batch_size=4,
                                size_mu=2.5, size_sigma=0.8, **extra)
    params, loss = make_task_model(task, 0, device="cpu", **small)
    opt = (adam(4e-5) if task == "mlm" else
           sgd(0.8 if task == "tg" else 0.05, momentum=0.9,
               weight_decay=5e-4))
    return FederatedEngine(
        dataset=ds, loss_fn=loss, init_params=params, optimizer=opt,
        placement=make_placement("lb"), sampler=UniformSampler(64, 8),
        pool=WorkerPool.homogeneous(cfg.pop("workers", 2), type_name="a40",
                                    concurrency=2),
        telemetry=SyntheticTelemetry(),
        strategy=strategy_from_name(strategy),
        config=EngineConfig(steps_cap=2, batch_size=4, lanes_per_worker=2,
                            pipeline_depth=depth, rounds_per_checkpoint=2,
                            **cfg),
        checkpoint_store=CheckpointStore(str(ckpt)) if ckpt else None,
        device=device)


@pytest.mark.parametrize("task", ["ic", "tg", "mlm"])
def test_task_rounds_on_card_track_the_cpu(dev, task):
    """Two rounds of each reduced task on the card: K1 once per lane-loop
    step, bitwise across depths, and within rtol 1e-5 of the CPU's losses
    (GEMM and reduction sums in another order; TG's recurrence and MLM's
    softmax stay inside it) and 1e-4 + 1e-6 of its params."""
    tops.reset_launch_counts()
    card = _task_engine(task, "cuda")
    res = card.run(2)
    torch.cuda.synchronize()
    assert tops.launch_counts()["fedavg_accum"] == sum(r.s_steps
                                                       for r in res)
    cpu = _task_engine(task, "cpu")
    cres = cpu.run(2)
    np.testing.assert_allclose([r.loss for r in res],
                               [r.loss for r in cres], rtol=1e-5)
    for k, v in cpu.params.items():
        assert torch.allclose(card.params[k].cpu(), v, rtol=1e-4,
                              atol=1e-6), k
    assert [r.loss for r in _task_engine(task, "cuda", depth=0).run(2)] \
        == [r.loss for r in res]


def test_fedmedian_on_card(dev):
    """The median reduce is bitwise the CPU's (sorting is exact and
    ``(lo + hi) * 0.5`` one rounding), for odd and even counts and at
    SR's flat size; the gather path launches no K1 and its losses are
    bitwise across depths."""
    from repro_torch.core.aggregation import median_leading
    for n in (3, 4):
        x = _rand((n, 4_244_992), torch.float32, "cpu", 30 + n)
        assert torch.equal(median_leading(x.to(dev)).cpu(),
                           median_leading(x))
    tops.reset_launch_counts()
    runs = [[r.loss for r in _task_engine("sr", "cuda", depth=d,
                                          strategy="fedmedian").run(3)]
            for d in (0, 1)]
    torch.cuda.synchronize()
    assert tops.launch_counts()["fedavg_accum"] == 0
    assert runs[0] == runs[1] and all(np.isfinite(runs[0]))


@pytest.mark.parametrize("mesh", [{}, dict(workers=4, mesh_workers=2,
                                           combine_mode="tree",
                                           combine_compress="int8")],
                         ids=["fused", "int8"])
def test_resume_on_card_is_bitwise(dev, mesh, tmp_path):
    """4 rounds with a checkpoint every 2, restore into a new engine, 2
    more: bitwise rounds 4-5 of an uninterrupted 6-round run."""
    whole = [r.loss for r in _task_engine("sr", "cuda", **mesh).run(6)]
    _task_engine("sr", "cuda", ckpt=tmp_path, **mesh).run(4)
    eng = _task_engine("sr", "cuda", ckpt=tmp_path, **mesh)
    assert eng.restore_latest() and eng.round_idx == 4
    assert [r.loss for r in eng.run(2)] == whole[4:]


def test_fedmedian_non_finite_column_on_card(dev):
    """A NaN in one client's model makes its column NaN on the card as on
    the CPU (``jnp.median``'s rule); ±inf columns and the finite rest are
    bitwise the CPU's."""
    from repro_torch.core.aggregation import median_leading
    for n in (3, 4):
        x = _rand((n, 4_244_992), torch.float32, "cpu", 40 + n)
        x[n // 2, 7] = float("nan")
        x[0, 11], x[1, 11] = float("inf"), float("-inf")
        x[0, 12] = float("inf")
        got, want = median_leading(x.to(dev)).cpu(), median_leading(x)
        assert torch.isnan(got[7]) and torch.isnan(want[7])
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        finite = ~torch.isnan(want)
        assert torch.equal(got[finite], want[finite])


def test_memory_probe_on_card(dev):
    """``round_memory_analysis`` runs one lane-loop round and reads the
    allocator: arguments are the params plus the round's inputs, the
    outputs the new params plus metrics; more lanes need more temp bytes;
    the estimate it feeds fits its budget."""
    from repro_torch.core import (DeviceSpec, estimate_slots_from_memory_analysis,
                                  round_memory_analysis)
    eng = _task_engine("sr", "cuda")
    params_bytes = sum(v.numel() * 4 for v in eng.params.values())
    one = round_memory_analysis(eng, slots_compiled=1)
    two = round_memory_analysis(eng, slots_compiled=2)
    for m in (one, two):
        assert m.argument_size_in_bytes > params_bytes
        assert m.output_size_in_bytes >= params_bytes
        assert m.peak_bytes >= m.argument_size_in_bytes
    assert two.temp_size_in_bytes > one.temp_size_in_bytes
    spec = DeviceSpec.from_card()
    est = estimate_slots_from_memory_analysis(two, slots_compiled=2,
                                              group_devices=1, device=spec)
    assert est.slots >= 1 and est.budget_bytes < spec.hbm_bytes
    assert eng.round_idx == 0 and eng.history == []


@pytest.mark.parametrize("policy", ["reuse", "stall"])
def test_measured_mode_on_card(dev, policy):
    """Measured telemetry from the card's own syncs: the fused path's
    dispatch-to-loss-sync time attributed by share, the mesh path's
    per-worker sync times exact; the refit barrier's audit is clean at
    depths 0-2."""
    for depth in (0, 1, 2):
        eng = _task_engine("sr", "cuda", depth=depth,
                           telemetry_mode="measured", barrier_policy=policy)
        eng.run(6)
        st = eng.control_stats
        assert st["audit_violations"] == 0 and eng.control.audit() == []
        assert st["barrier"]["rows_attributed"] > 0
        assert eng.placement.ready_for(eng.pool.snapshot())
    eng = _task_engine("sr", "cuda", workers=4, mesh_workers=2,
                       combine_mode="tree", combine_compress="int8",
                       telemetry_mode="measured", barrier_policy=policy)
    eng.run(4)
    st = eng.control_stats
    assert st["barrier"]["rows_attributed"] == 0
    assert st["barrier"]["rows_exact"] > 0 and st["audit_violations"] == 0
    assert set(st["worker_residuals"]) == {0, 1, 2, 3}


def test_synthetic_control_bitwise_across_depths_on_card(dev):
    runs = {}
    for depth in (0, 1, 2):
        eng = _task_engine("sr", "cuda", depth=depth, drift_threshold=0.01,
                           adapt_interval=2)
        runs[depth] = [(r.loss, r.drift_fallback) for r in eng.run(8)]
        assert eng.control.autoconc.updates > 0
    assert runs[0] == runs[1] == runs[2]


@pytest.mark.parametrize("mesh", [0, 2], ids=["fused", "mesh"])
def test_device_cache_on_card_is_bitwise_cache_off(dev, mesh):
    """SR rounds with the device cache on the card: losses bitwise equal to
    the cache-off run at depths 0/1/2, hits served, K1 launched exactly as
    often (the assembly launches no kernel of the port's)."""
    def run(depth, rows):
        tops.reset_launch_counts()
        eng = _task_engine("sr", "cuda", depth=depth, mesh_workers=mesh,
                           device_cache_batches=rows)
        res = eng.run(6)
        torch.cuda.synchronize()
        return [r.loss for r in res], tops.launch_counts(), eng.cache_stats

    off, k_off, _ = run(1, 0)
    assert all(np.isfinite(off))
    for depth in (0, 1, 2):
        on, k_on, st = run(depth, 24)
        assert on == off, depth
        assert k_on == k_off
        assert st["hit_steps"] > 0
