"""The port's dry-run tooling (``repro_torch.launch.{plan, steps, op_cost,
roofline, dryrun, report}``, ``kernels/work.py`` and the kernel routes'
meta branch) against the JAX reference on the CPU.

* plans, ``runnable``/``skip_reason``, ``param_bytes``, ``model_flops``,
  ``input_specs`` and ``roofline_terms``: exactly the reference's, on every
  cell of ``{"data": 1, "model": 1}`` and ``{"pod": 1, "data": 1, "model":
  1}`` (the sharding hooks excepted: the port leaves them unset);
* the counter on ``tests/test_hlo_cost.py``'s cases: exact;
* the counter's matrix-product FLOPs against the dots of the reference's
  compiled HLO, walked with its own ``_parse_computations``,
  ``_trip_count`` and ``_dot_flops`` (dots only, multiplied through the
  loops): exact (tolerance 0) on a reduced qwen3 prefill and the small SR
  round.  No dot counts differently: the losses' gold picks are a gather
  (reference) and a one-hot multiply-and-sum (port), products of neither;
  XLA keeps every other product a dot;
* K1–K5 on meta: the kernels' output shapes, their work from
  ``kernels/work.py``, and no launch counted.
"""

import dataclasses
import math
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import _torch_parity as par  # noqa: E402
from repro.configs import ARCH_NAMES, SHAPES  # noqa: E402
from repro.configs import get_arch as jget  # noqa: E402
from repro.fl.round import make_round_step as jround  # noqa: E402
from repro.launch import hlo_cost as jhlo  # noqa: E402
from repro.launch import plan as jplan  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.papertasks import TASK_MODELS as JTASKS  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.core.concurrency import DeviceSpec  # noqa: E402
from repro_torch.distributed.sharding import ExpertSplit  # noqa: E402
from repro_torch.fl import round as tround  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.launch import dryrun, report, steps  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import op_cost  # noqa: E402
from repro_torch.launch import plan as tplan  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.papertasks import TASK_MODELS  # noqa: E402
from repro_torch.optim import sgd as tsgd  # noqa: E402

MESHES = [{"data": 1, "model": 1}, {"pod": 1, "data": 1, "model": 1}]
HOOKS = {"act_shard", "act_shard_logits", "act_shard_moe", "moe_dispatch",
         "act_gather"}


def _mesh(axes):
    return make_test_mesh(tuple(axes.values()), tuple(axes))


def _knobs(cfg):
    return {k: v for k, v in cfg.to_dict().items() if k not in HOOKS}


def _tmesh(axes):
    """The port's counting mesh of the same shape (no process group)."""
    return tmesh.make_mesh(tuple(axes.values()), tuple(axes), backend="meta")


def _same_plan(jp, tp):
    """The same plan, the XLA layout hooks ``act_shard``, ``act_gather``
    and ``act_shard_logits`` unset (the specs' ``"act"``/``"logits"``
    layouts carry them); where the port set ``act_shard_moe`` (given a
    mesh) the reference set it too, as an ``ExpertSplit`` over ``model``;
    where the port set ``moe_dispatch``, the reference set it too, with
    the same FSDP axis."""
    for f in dataclasses.fields(jp):
        if f.name != "cfg":
            assert getattr(tp, f.name) == getattr(jp, f.name), f.name
    assert _knobs(tp.cfg) == _knobs(jp.cfg)
    assert all(getattr(tp.cfg, h) is getattr(tget(tp.arch), h)
               for h in HOOKS - {"moe_dispatch", "act_shard_moe"})
    if tp.cfg.act_shard_moe is not None:
        assert jp.cfg.act_shard_moe is not None
        assert isinstance(tp.cfg.act_shard_moe, ExpertSplit)
        assert tp.cfg.act_shard_moe.axis == "model"
    if tp.cfg.moe_dispatch is not None:
        assert jp.cfg.moe_dispatch is not None
        assert tp.cfg.moe_dispatch.fsdp_axis == (
            "data" if "data" not in jp.worker_axes else None)


# -- the planner -----------------------------------------------------------------
@pytest.mark.parametrize("axes", MESHES, ids=["pod1", "multipod1"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_plan_matches_reference_on_every_cell(arch, axes):
    mesh = _mesh(axes)
    for shape in SHAPES:
        assert tplan.runnable(tget(arch), shape) == \
            jplan.runnable(jget(arch), shape)
        assert tplan.skip_reason(tget(arch), shape) == \
            jplan.skip_reason(jget(arch), shape)
        if not jplan.runnable(jget(arch), shape):
            with pytest.raises(ValueError, match="skipped"):
                tplan.make_plan(arch, shape, axes)
            continue
        jp = jplan.make_plan(arch, shape, mesh)
        tp = tplan.make_plan(arch, shape, _tmesh(axes))
        _same_plan(jp, tp)
        assert (tp.cfg.moe_dispatch is None) == (jp.cfg.moe_dispatch is None)
        assert (tp.cfg.act_shard_moe is None) == \
            (jp.cfg.act_shard_moe is None)
        # On axis sizes alone (the one-card dry-run) no hook is set.
        flat = tplan.make_plan(arch, shape, axes)
        _same_plan(jp, flat)
        assert flat.cfg.moe_dispatch is None
        assert flat.cfg.act_shard_moe is None


def test_plan_overrides_match_reference():
    """``tests/test_plan.py::test_plan_overrides`` in both packages."""
    axes = MESHES[0]
    over = {"worker_axes": ("data", "model"), "W": 256, "P": 1, "S": 1,
            "b": 1, "attn_impl": "dense"}
    jp = jplan.make_plan("qwen3-0.6b", "train_4k", _mesh(axes),
                         overrides=over)
    tp = tplan.make_plan("qwen3-0.6b", "train_4k", axes, overrides=over)
    _same_plan(jp, tp)
    assert tp.worker_axes == ("data", "model") and tp.cfg.attn_impl == "dense"
    bad = {"W": 7, "P": 1, "S": 1, "b": 1}
    for make, m in ((jplan.make_plan, _mesh(axes)), (tplan.make_plan, axes)):
        with pytest.raises(ValueError):
            make("qwen3-0.6b", "train_4k", m, overrides=bad)
    # The run cells' overrides.
    for arch, shape, over in (("qwen3-0.6b", "train_4k", {"S": 32, "b": 8}),
                              ("mamba2-2.7b", "prefill_32k",
                               {"b": 1, "ssd_impl": "pallas"})):
        _same_plan(jplan.make_plan(arch, shape, _mesh(axes), overrides=over),
                   tplan.make_plan(arch, shape, axes, overrides=over))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_bytes_and_model_flops_match_reference(arch):
    jcfg, tcfg = jget(arch), tget(arch)
    assert tplan.param_bytes(tcfg) == jplan.param_bytes(jcfg)
    for kind, tokens in (("train", 256 * 4096), ("serve", 32 * 32768)):
        assert troof.model_flops(tcfg, tokens, kind) == \
            jroof.model_flops(jcfg, tokens, kind)
    # meta_params: the reference's leaves, shapes and dtypes.
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                            jax.random.key(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(shapes)[0])
    meta = tplan.meta_params(tcfg)
    from repro_torch.kernels.layout import flatten_tree
    tflat = flatten_tree(meta)
    jflat = {"/".join(k.key for k in path): v for path, v in flat.items()}
    assert sorted(tflat) == sorted(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(jflat[k].dtype), k


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_match_reference(arch):
    axes = MESHES[0]
    mesh = _mesh(axes)
    for shape in SHAPES:
        if not jplan.runnable(jget(arch), shape):
            continue
        jspec = jplan.input_specs(jplan.make_plan(arch, shape, mesh))
        tspec = tplan.input_specs(tplan.make_plan(arch, shape, axes))
        jl = jax.tree_util.tree_flatten_with_path(jspec)[0]
        tl = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t, tspec,
                         is_leaf=lambda x: isinstance(x, torch.Tensor)))[0]
        assert [p for p, _ in tl] == [p for p, _ in jl], shape
        for (path, t), (_, j) in zip(tl, jl):
            assert t.device.type == "meta"
            assert tuple(t.shape) == j.shape, (shape, path)
            assert str(t.dtype).removeprefix("torch.") == str(j.dtype)


@pytest.mark.parametrize("name", ["qwen3-0.6b", "mamba2-2.7b",
                                  "granite-moe-3b-a800m", "whisper-base",
                                  "internvl2-26b", "jamba-v0.1-52b"])
def test_leaf_dtypes_and_device_params_follow_init(name):
    """``leaf_dtype`` and ``device_params`` give each leaf the dtype and
    shape ``init_params`` gives it; the fixed leaves are its values."""
    cfg = replace(tget(name).reduced(), dtype="bfloat16")
    ref = tlm.init_params(0, cfg, device="cpu")
    got = steps.device_params(cfg, 3, "cpu")
    from repro_torch.kernels.layout import flatten_tree
    ref, got = flatten_tree(ref), flatten_tree(got)
    assert list(got) == list(ref)
    for k, v in ref.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert tlm.leaf_dtype(k.rsplit("/", 1)[-1], cfg) == v.dtype, k
        if tlm.fixed_leaf(k.rsplit("/", 1)[-1], v.shape, v.dtype) is not None:
            assert torch.equal(got[k], v), k
        else:
            assert float(got[k].float().abs().max()) > 0, k


@pytest.mark.parametrize("flops,nbytes", [(3.2e15, 1e9), (1e12, 5e12),
                                          (0.0, 0.0), (7e14, 3e11)])
def test_roofline_terms_match_reference(flops, nbytes):
    ref_hw = jroof.HW()
    hw = troof.HW(peak_flops={"bfloat16": ref_hw.peak_flops},
                  hbm_bw=ref_hw.hbm_bw)
    assert troof.roofline_terms(flops_per_device={"bfloat16": flops},
                                bytes_per_device=nbytes, hw=hw) == \
        jroof.roofline_terms(flops_per_device=flops, bytes_per_device=nbytes,
                             wire_ici=0.0, wire_dcn=0.0, hw=ref_hw)


def test_card_rates_and_terms_by_dtype():
    spec = DeviceSpec()
    hw = troof.HW.from_spec(spec)
    assert spec.peak_flops_f32 == 67e12 and "peak_flops_f32" not in vars(spec)
    assert hw == troof.HW()
    assert hw.peak("bfloat16") == 989e12 and hw.peak("float32") == 67e12
    assert hw.peak("int64") == 67e12 and hw.hbm_bw == 3.35e12
    t = troof.roofline_terms(flops_per_device={"bfloat16": 989e12,
                                               "float32": 67e12},
                             bytes_per_device=3.35e12)
    assert math.isclose(t["compute_s"], 2.0) and t["memory_s"] == 1.0
    assert t["collective_s"] == 0.0 and t["dominant"] == "compute_s"


# -- the counter on tests/test_hlo_cost.py's cases -------------------------------
def _scan(x, w):
    for wi in w:
        x = torch.tanh(x @ wi)
    return x


def test_counter_counts_every_loop_trip():
    x = torch.empty(128, 128, device="meta")
    w = torch.empty(10, 128, 128, device="meta")
    ten = op_cost.analyze_step(_scan, x, w)
    one = op_cost.analyze_step(_scan, x, w[:1])
    mm = 2 * 128 ** 3
    assert ten.matmul_flops == 10 * mm and one.matmul_flops == mm
    assert ten.flops == {"float32": 10 * (mm + 128 * 128)}
    assert ten.bytes == 10 * one.bytes
    # each trip: mm reads x and wi, writes its output; tanh reads, writes
    assert one.bytes == 4 * (3 * 128 * 128 + 2 * 128 * 128)
    nested = op_cost.analyze_step(
        lambda x, w: [x := _scan(x, wi[None].expand(5, -1, -1)) for wi in w],
        torch.empty(64, 64, device="meta"), torch.empty(4, 64, 64,
                                                        device="meta"))
    assert nested.matmul_flops == 4 * 5 * 2 * 64 ** 3


def test_counter_counts_the_gradient_products():
    def loss(x, w):
        with torch.enable_grad():
            out = torch.tanh(x @ w).sum()
            return torch.autograd.grad(out, (x, w))
    x = torch.empty(64, 64, device="meta", requires_grad=True)
    w = torch.empty(64, 64, device="meta", requires_grad=True)
    cost = op_cost.analyze_step(loss, x, w)
    assert cost.matmul_flops == 3 * 2 * 64 ** 3
    assert cost.by_op["aten.mm"]["count"] == 3


def test_views_move_no_bytes_and_peak_is_exact():
    def views(x):
        return x.t().t().reshape(-1)[:7].view(7, 1).expand(7, 3)
    cost = op_cost.analyze_step(views, torch.empty(4, 8, device="meta"))
    assert cost.bytes == 0 and cost.total_flops == 0
    assert cost.peak_live_bytes == cost.argument_bytes == 4 * 8 * 4

    def allocs(x):
        a = x + 1.0                       # 4 KB
        b = a * 2.0                       # 8 KB live
        del a                             # 4 KB
        c = torch.zeros(2048, device=x.device, dtype=torch.float64)  # 20 KB
        del c                             # 4 KB
        return b.sum()                    # + 4 B
    cost = op_cost.analyze_step(allocs, torch.empty(1024, device="meta"))
    assert cost.argument_bytes == 4096
    assert cost.peak_live_bytes == 4096 + 4096 + 16384
    assert cost.output_bytes == 4
    assert cost.by_op["aten.add"]["bytes"] == 8192


def test_peak_holds_the_softmax_and_logsumexp_workspace():
    """The peak adds, during an op, the buffers PyTorch's CUDA softmax and
    logsumexp hold inside themselves: a contiguous copy of a non-contiguous
    operand, the backward's ``grad * output``, ``exp(x - max)``."""
    kb16 = 64 * 64 * 4

    def backward(x, g):
        y = torch._softmax(x, -1, False)          # contiguous: no copy
        return torch._softmax_backward_data(g.t(), y, -1, torch.float32)

    x, g = (torch.empty(64, 64, device="meta") for _ in range(2))
    cost = op_cost.analyze_step(backward, x, g)
    # arguments, y and the output, then g.t()'s copy and grad * output
    assert cost.peak_live_bytes == 2 * kb16 + 2 * kb16 + 2 * kb16
    cost = op_cost.analyze_step(lambda x, g: torch._softmax_backward_data(
        g, x, -1, torch.float32), x, g)
    assert cost.peak_live_bytes == 2 * kb16 + kb16 + kb16
    cost = op_cost.analyze_step(lambda x: torch.logsumexp(x, -1), x)
    assert cost.peak_live_bytes == kb16 + 64 * 4 + kb16
    cost = op_cost.analyze_step(lambda x: torch._softmax(x.t(), -1, False),
                                x)
    assert cost.peak_live_bytes == kb16 + kb16 + kb16


def test_counter_names_a_data_dependent_op():
    with pytest.raises(op_cost.DataDependentOp) as e:
        op_cost.analyze_step(lambda x: float(x.sum()),
                             torch.empty(4, device="meta"))
    assert e.value.op == "aten._local_scalar_dense"
    with pytest.raises(op_cost.DataDependentOp, match="nonzero"):
        op_cost.analyze_step(torch.nonzero, torch.empty(4, device="meta"))
    # On real tensors the same step counts.
    assert op_cost.analyze_step(lambda x: float(x.sum()),
                                torch.ones(4)).total_flops == 4


# -- the counter against the reference's HLO walker ------------------------------
def _ref_dots(text: str) -> tuple[float, list]:
    """Dot FLOPs of a compiled HLO module, each multiplied by the trip
    counts of the loops around it (``analyze_hlo``'s walk, dots only)."""
    comps = jhlo._parse_computations(text)
    referenced = set()
    for c in comps.values():
        for op in c.ops.values():
            for key in ("calls", "body", "condition", "to_apply"):
                t = jhlo._attr(op.line, key)
                if t:
                    referenced.add(t)
    entry = [c for c in comps if c not in referenced][-1]
    dots = []

    def walk(name, mult):
        comp = comps[name]
        for op_name in comp.order:
            op = comp.ops[op_name]
            if op.opcode == "dot":
                dots.append((mult, jhlo._dot_flops(comp, op), op.type_str))
            elif op.opcode == "while":
                trips = jhlo._trip_count(comps, jhlo._attr(op.line,
                                                           "condition"))
                walk(jhlo._attr(op.line, "body"), mult * trips)
            elif op.opcode in ("fusion", "call", "async-start"):
                callee = jhlo._attr(op.line, "calls")
                if callee in comps:
                    walk(callee, mult)
            elif op.opcode == "conditional":
                for key in ("true_computation", "false_computation"):
                    if jhlo._attr(op.line, key) in comps:
                        walk(jhlo._attr(op.line, key), mult)

    walk(entry, 1.0)
    return sum(m * f for m, f, _ in dots), dots


def test_counter_matches_reference_dots_on_reduced_prefill():
    jcfg = jget("qwen3-0.6b").reduced()
    tcfg = tget("qwen3-0.6b").reduced()
    b, s = 2, 64
    jp = jax.eval_shape(lambda k: jlm.init_params(k, jcfg), jax.random.key(0))
    batch = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    text = jax.jit(lambda p, x: jlm.prefill(p, x, jcfg)).lower(
        jp, batch).compile().as_text()
    want, _ = _ref_dots(text)
    plan = dataclasses.replace(tplan.make_plan(tcfg, "prefill_32k"),
                               seq_len=s, b=b, cfg=tcfg)
    fn, args = steps.build_step(plan, "meta")
    got = op_cost.analyze_step(fn, *args).matmul_flops
    assert got == want


def test_counter_matches_reference_dots_on_sr_round():
    """The small SR round (2 workers × 2 lanes, ``steps_cap`` 4, forward,
    backward and the folds): the same products in both packages."""
    ds = par.small_dataset()
    params, arr = par.ref_params(), par.ref_round_arrays(ds)
    jstep = jround(JTASKS["sr"].loss_fn,
                   jsgd(par.LR, momentum=par.MOMENTUM, weight_decay=par.WD))
    text = jax.jit(jstep).lower(
        jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, arr.batches), arr.step_mask, arr.boundary,
        arr.weight).compile().as_text()
    want, _ = _ref_dots(text)
    tstep = tround.make_round_step(
        TASK_MODELS["sr"].loss_fn,
        tsgd(par.LR, momentum=par.MOMENTUM, weight_decay=par.WD))
    meta = {k: torch.empty(v.shape, device="meta") for k, v in params.items()}
    batches = {k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype,
                              device="meta") for k, v in arr.batches.items()}
    masks = [torch.from_numpy(a.copy()).to("meta")
             for a in (arr.step_mask, arr.boundary, arr.weight)]
    cost = op_cost.analyze_step(tstep, meta, batches, *masks)
    assert cost.matmul_flops == want > 0


# -- the kernels on meta ----------------------------------------------------------
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


KERNEL_CALLS = {
    "fedavg_accum": (
        lambda: tops.fedavg_accum(_meta(2, 300, 5), _meta(2, 300, 5),
                                  _meta(2), _meta(2)),
        (2, 300, 5), work.fedavg_accum((2, 300, 5), torch.float32)),
    "dequant_merge": (
        lambda: tops.dequant_merge_flat(
            _meta(1000), _meta(1000, dtype=torch.int8), _meta(1000),
            _meta(3), _meta(4, dtype=torch.int64), 1.0, 2.0),
        (1000,), work.dequant_merge(1000)),
    "rmsnorm": (
        lambda: tops.rmsnorm(_meta(4, 7, 64, dtype=torch.bfloat16),
                             _meta(64)),
        (4, 7, 64), work.rmsnorm(28, 64, torch.bfloat16)),
    "flash_attention": (
        lambda: tops.flash_attention(
            _meta(2, 300, 8, 64, dtype=torch.bfloat16),
            _meta(2, 300, 2, 64, dtype=torch.bfloat16),
            _meta(2, 300, 2, 64, dtype=torch.bfloat16)),
        (2, 300, 8, 64),
        work.flash_attention((2, 300, 8, 64), (2, 300, 2, 64),
                             torch.bfloat16, causal=True)),
    "ssd": (
        lambda: tops.ssd(_meta(2, 300, 8, 16, dtype=torch.bfloat16),
                         _meta(2, 300, 8), _meta(8),
                         _meta(2, 300, 1, 32, dtype=torch.bfloat16),
                         _meta(2, 300, 1, 32, dtype=torch.bfloat16),
                         _meta(8), return_state=True),
        (2, 300, 8, 16),
        work.ssd((2, 300, 8, 16), (2, 300, 1, 32), torch.bfloat16,
                 torch.float32, chunk=128, state=True)),
}


@pytest.mark.parametrize("kernel", list(KERNEL_CALLS))
def test_kernel_route_on_meta_reports_its_work(kernel):
    call, shape, want = KERNEL_CALLS[kernel]
    tops.reset_launch_counts()
    seen = []
    with work.counting(lambda name, w: seen.append((name, w))):
        out = call()
    y = out[0] if isinstance(out, tuple) else out
    assert y.device.type == "meta" and tuple(y.shape) == shape
    if kernel == "ssd":
        assert tuple(out[1].shape) == (2, 8, 16, 32)
        assert out[1].dtype == torch.float32
    assert seen == [(kernel, want)]
    assert set(tops.launch_counts().values()) == {0}
    # Outside a counter the report is dropped; the route still answers.
    assert call() is not None and set(tops.launch_counts().values()) == {0}
    cost = op_cost.analyze_step(call)
    assert cost.kernels[kernel] == {"calls": 1, "flops": want.flops,
                                    "bytes": want.bytes,
                                    "dtype": str(want.dtype)[6:]}


def test_work_counts():
    assert work.fedavg_accum((4, 10), torch.bfloat16) == work.Work(
        240, 160, torch.float32)
    w = work.flash_attention((1, 4, 2, 8), (1, 4, 1, 8), torch.bfloat16,
                             causal=True)
    assert w.flops == 4 * 2 * 10 * 8 and w.dtype == torch.bfloat16
    assert work.flash_attention((1, 4, 2, 8), (1, 6, 1, 8), torch.float32,
                                causal=False).flops == 4 * 2 * 24 * 8
    s = work.ssd((1, 10, 2, 4), (1, 10, 1, 3), torch.float32, torch.float32,
                 chunk=8, state=False)
    assert s.bytes == 4 * (80 + 20 + 4 + 60 + 80)
    tri = 8 * 9 // 2 + 2 * 3 // 2
    assert s.flops == 2 * 3 * tri + 2 * 2 * tri * 4 + 2 * 2 * 2 * 3 * 4 \
        + 2 * 2 * 10 * 4 * 3


# -- the dry-run and the report ---------------------------------------------------
def test_run_cell_record_and_report(tmp_path, capsys):
    assert dryrun.main(["--arch", "mamba2-2.7b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0
    recs = {r["arch"]: r for r in report.load(str(tmp_path))}
    skip = recs["qwen3-0.6b"]
    assert skip["status"] == "skip"
    assert skip["reason"] == jplan.skip_reason(jget("qwen3-0.6b"),
                                               "long_500k")
    rec = recs["mamba2-2.7b"]
    assert rec["status"] == "ok" and rec["fits"] and rec["kind"] == "decode"
    assert (rec["W"], rec["P"], rec["S"], rec["b"]) == (1, 1, 1, 1)
    assert rec["param_bytes"] == jplan.param_bytes(jget("mamba2-2.7b"))
    assert rec["model_flops_total"] == jroof.model_flops(
        jget("mamba2-2.7b"), 1, "serve")
    assert rec["roofline"]["collective_s"] == 0.0
    assert 0 < rec["useful_ratio"] <= 1.5
    assert rec["memory_analysis"]["peak_live_bytes"] >= rec["param_bytes"]
    tables = report.dryrun_table(list(recs.values())) + \
        report.roofline_table(list(recs.values()))
    assert "mamba2-2.7b" in tables and "skip" in tables
    assert report.main(["--dir", str(tmp_path)]) == 0
    assert "Dry-run table" in capsys.readouterr().out


def test_run_cell_names_the_op_of_a_failing_step(monkeypatch):
    def reads_back(plan, device):
        return (lambda x: float(x.sum())), (torch.empty(3, device=device),)
    monkeypatch.setattr(dryrun, "build_step", reads_back)
    rec = dryrun.run_cell("whisper-base", "decode_32k")
    assert rec["status"] == "fail" and rec["op"] == "aten._local_scalar_dense"


def test_run_cell_measure_needs_the_card():
    with pytest.raises(RuntimeError):
        dryrun.run_cell("mamba2-2.7b", "long_500k", run=True, device="cpu")


def test_parse_overrides_and_first_step():
    assert dryrun.parse_overrides(["S=32", "attn_impl=pallas",
                                   "worker_axes=data,model", "seq_axes="]) \
        == {"S": 32, "attn_impl": "pallas",
            "worker_axes": ("data", "model"), "seq_axes": ()}
    plan = tplan.make_plan("qwen3-0.6b", "train_4k",
                           overrides={"S": 32, "b": 8})
    fn, args = steps.build_step(plan)
    one = dryrun.first_step(plan, args)
    assert one[0] is args[0] and one[1]["tokens"].shape == (1, 1, 1, 8, 4096)
    assert all(m.shape == (1, 1, 1) for m in one[2:])
