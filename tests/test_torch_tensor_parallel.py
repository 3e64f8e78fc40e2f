"""The tensor-parallel split on a meta mesh: what each rank of a
(2, 2) ("data", "model") mesh moves in one training round of the
reference's ``train_4k`` plan, counted by ``distributed.collectives``
(nothing computed), and the layouts the plan hands the model.

* ``tp`` (qwen3-0.6b, granite-moe-3b-a800m; 2 layers): every layer is
  split over ``model``, so no dense weight, expert or embedding row is
  all-gathered over ``model`` — nothing is, and the split products are
  all-reduced over it;
* ``fsdp_tp`` with sequence parallelism (qwen3-moe-235b-a22b, 1 layer):
  everything all-gathered over ``model`` is the residual stream of the
  rank's sequences (a block's entry, the MoE dispatch's, the head's), the
  split products are reduce-scattered over the sequence;
* ``fsdp_tp`` without the dispatch (qwen3-moe-235b-a22b, 1 layer, and
  jamba-v0.1-52b, one 8-layer period; a round and a prefill): under the
  plan's ``act_shard_moe`` split no expert leaf is all-gathered over
  ``model`` — each rank gathers its own experts over ``data`` only;
* the collectives' own records: a reduce-scatter's payload and ring wire
  bytes, ``split`` moving nothing forward;
* mamba2-2.7b ``tp`` (2 layers): each Mamba mixer is split by heads, so
  neither ``mamba_in`` nor ``mamba_out`` is all-gathered over ``model`` —
  only the in-projection's activations and ``mamba_conv`` are;
* jamba-v0.1-52b's decode step (one 8-layer period at its published
  widths on a meta (1, 2) mesh, 4 sequences): no weight and no cache leaf
  is all-gathered over ``model``, nothing larger than one token's packed
  in-projection or its query heads.

The values of the split path are held to the reference in
``test_torch_sharded_serve.py`` and ``test_torch_sharded_train.py``.
"""

from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed.sharding import shard_tree  # noqa: E402
from repro_torch.launch import plan as tplan  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402

AXES = ("data", "model")


def _round_collectives(arch, n_layers):
    """The plan of ``arch``'s train_4k cell on a meta (2, 2) mesh, its
    config cut to ``n_layers``: (the plan, every collective one rank's
    round records)."""
    mesh = make_mesh((2, 2), AXES, backend="meta")
    plan = tplan.make_plan(arch, "train_4k", mesh,
                           overrides={"n_layers": n_layers})
    fn, args = build_step(plan, "meta", mesh=mesh)
    seen = []
    with coll.counting(seen.append):
        fn(*args)
    return plan, seen


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_tp_round_gathers_nothing_over_model(arch):
    plan, seen = _round_collectives(arch, 2)
    assert plan.policy == "tp" and plan.worker_axes == ("data",)
    kinds = {(c.kind, c.axis) for c in seen}
    assert ("all-gather", "model") not in kinds
    assert ("all-reduce", "model") in kinds
    assert ("reduce-scatter", "model") not in kinds


def test_sequence_parallel_round_gathers_only_the_stream_over_model():
    plan, seen = _round_collectives("qwen3-moe-235b-a22b", 1)
    assert plan.policy == "fsdp_tp" and plan.seq_axes == ("model",)
    cfg = plan.cfg
    b_rank = plan.b // 2                    # the batch over data
    stream = b_rank * plan.seq_len * cfg.d_model * 2        # bf16
    over_model = [c for c in seen if c.axis == "model"]
    gathers = [c.bytes for c in over_model if c.kind == "all-gather"]
    assert gathers and set(gathers) == {stream}
    scatters = [c.bytes for c in over_model if c.kind == "reduce-scatter"]
    assert stream in scatters
    # The head's vocabulary-parallel CE: maxima and sums over model.
    assert any(c.kind == "all-reduce" for c in over_model)


def _expert_shapes(cfg, e, d):
    """The shapes an expert leaf of a period takes with ``e`` experts and
    ``d`` rows of ``D``: ``moe_gate``/``moe_up`` ``[e, d, F]``, ``moe_down``
    ``[e, F, d]``."""
    return {(e, d, cfg.moe_d_ff), (e, cfg.moe_d_ff, d)}


@pytest.mark.parametrize("arch,n_layers", [("qwen3-moe-235b-a22b", 1),
                                           ("jamba-v0.1-52b", 8)])
@pytest.mark.parametrize("step", ["round", "prefill"])
def test_fsdp_tp_without_dispatch_gathers_no_expert_over_model(arch,
                                                               n_layers,
                                                               step):
    """No all-gather over ``model`` carries an expert leaf, whole or in
    part (judged by the payloads' shapes); each rank gathers its own
    ``E/2`` experts over ``data``."""
    mesh = make_mesh((2, 2), AXES, backend="meta")
    shape = "train_4k" if step == "round" else "prefill_32k"
    plan = tplan.make_plan(arch, shape, mesh,
                           overrides={"n_layers": n_layers})
    cfg = replace(plan.cfg, moe_dispatch=None)
    assert cfg.act_shard_moe is not None and plan.policy == "fsdp_tp"
    seen = []
    if step == "round":
        fn, args = build_step(replace(plan, S=1, b=2, cfg=cfg), "meta",
                              mesh=mesh)
        with coll.counting(seen.append):
            fn(*args)
    else:
        specs = tplan.sharding_specs(plan, mesh)
        kw = {k: specs[k] for k in ("params", "act", "logits")}
        kw["cache"] = tplan.cache_specs(cfg, specs["rules"], 4, 1024, mesh)
        params = shard_tree(tplan.meta_params(cfg), specs["params"], mesh)
        # The rank's 2 of 4 sequences.
        tokens = torch.zeros(2, 1024, dtype=torch.long, device="meta")
        with coll.counting(seen.append):
            lm.prefill(params, {"tokens": tokens}, cfg, max_len=1024,
                       mesh=mesh, device="meta", specs=kw)
    E, D = cfg.n_experts, cfg.d_model
    experts = set().union(*(_expert_shapes(cfg, e, d) for e in (E, E // 2)
                            for d in (D, D // 2)))
    gathers = [(c.axis, c.shape) for c in seen if c.kind == "all-gather"]
    assert not [g for g in gathers if g[0] == "model" and g[1] in experts]
    own = _expert_shapes(cfg, E // 2, D)
    assert {g[1] for g in gathers if g[0] == "data"} >= own


def test_reduce_scatter_and_split_record_the_ring():
    mesh = make_mesh((2, 4), AXES, backend="meta")
    x = torch.empty(3, 8, 5, device="meta")
    seen = []
    with coll.counting(seen.append):
        y = coll.reduce_scatter(x, mesh, "model", dim=1)
        z = coll.split(x, mesh, "model", dim=1)
    assert tuple(y.shape) == tuple(z.shape) == (3, 2, 5)
    (c,) = seen                              # split sends nothing
    assert (c.kind, c.axis, c.group_size) == ("reduce-scatter", "model", 4)
    assert c.shape == (3, 8, 5)
    assert c.bytes == 3 * 8 * 5 * 4
    assert c.wire_bytes == c.bytes * 3 / 4


@pytest.mark.parametrize("arch,shape,seq", [
    ("jamba-v0.1-52b", "prefill_32k", "model"),
    ("qwen3-0.6b", "decode_32k", None),
    ("qwen3-moe-235b-a22b", "train_4k", "model"),
    ("internlm2-1.8b", "train_4k", None),
    ("qwen3-0.6b", "train_4k", None)])
def test_plan_hands_the_model_its_layouts(arch, shape, seq):
    """The residual stream's layout (batch over the batch axes, the
    sequence over the plan's ``seq_axes``) and the logits' (the vocabulary
    over ``model``), as the reference's ``act_shard`` and
    ``act_shard_logits``; a train cell's in its lane specs, without the
    logits' where ``model`` is a worker axis (qwen3-0.6b's per-chip
    workers: nothing is split)."""
    mesh = {"data": 16, "model": 16}
    plan = tplan.make_plan(arch, shape, mesh)
    specs = tplan.sharding_specs(plan, mesh)
    if plan.kind == "train":
        specs = specs["lane"]
        assert ("logits" in specs) == ("model" not in plan.worker_axes)
        assert specs.get("logits", (None, None, "model"))[-1] == "model"
    else:
        assert specs["logits"] == (specs["act"][0], "model")
        assert specs["act"][0] == ("data" if plan.b > 1 else None)
    assert specs["act"][1] == seq
    assert get_arch(arch).padded_vocab % 16 == 0


def _in_width(cfg) -> int:
    """The packed ``[z | x | B | C | dt]`` in-projection's columns."""
    return 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state \
        + cfg.ssm_heads


def test_mamba_tp_round_gathers_no_mamba_weight_over_model():
    plan, seen = _round_collectives("mamba2-2.7b", 2)
    assert plan.policy == "tp" and plan.worker_axes == ("data",)
    cfg = plan.cfg
    nbytes = 2                                          # bf16
    mamba_in = cfg.d_model * _in_width(cfg) * nbytes
    mamba_out = cfg.d_inner * cfg.d_model * nbytes
    conv = cfg.ssm_conv * (cfg.d_inner + 2 * cfg.ssm_groups
                           * cfg.ssm_state) * nbytes
    proj = plan.b * plan.seq_len * _in_width(cfg) * nbytes
    gathers = {c.bytes for c in seen
               if (c.kind, c.axis) == ("all-gather", "model")}
    assert gathers == {proj, conv}
    assert mamba_in not in gathers and mamba_out not in gathers
    # Each mixer's gated norm: its sum of squares, f32, all-reduced.
    assert any(c.kind == "all-reduce" and c.axis == "model"
               and c.bytes == plan.b * plan.seq_len * 4 for c in seen)


def test_jamba_decode_step_gathers_no_weight_and_no_cache_over_model():
    mesh = make_mesh((1, 2), AXES, backend="meta")
    cfg = replace(get_arch("jamba-v0.1-52b"), n_layers=8)
    plan = tplan.make_plan(cfg, "decode_32k", mesh)
    cfg = replace(cfg, moe_dispatch=plan.cfg.moe_dispatch)
    specs = tplan.sharding_specs(plan, mesh)
    b, s, max_len = 4, 16, 64
    kw = {"mesh": mesh, "device": "meta",
          "specs": {k: specs[k] for k in ("params", "act", "logits")}}
    kw["specs"]["cache"] = tplan.cache_specs(cfg, specs["rules"], b,
                                             max_len, mesh)
    params = shard_tree(tplan.meta_params(cfg), specs["params"], mesh)
    tokens = torch.zeros(b, s, dtype=torch.long, device="meta")
    _, cache = lm.prefill(params, {"tokens": tokens}, cfg, max_len=max_len,
                          **kw)
    seen = []
    with coll.counting(seen.append):
        lm.decode_step(params, cache, tokens[:, :1], s, cfg, **kw)
    gathers = [c.bytes for c in seen
               if (c.kind, c.axis) == ("all-gather", "model")]
    bound = b * max(_in_width(cfg), cfg.n_heads * cfg.resolved_head_dim) * 2
    assert gathers and max(gathers) == b * _in_width(cfg) * 2 <= bound
    # The 7 Mamba layers' projections and conv outputs, the attention
    # layer's query heads and its new token's k and v.
    assert len(gathers) == 7 + 7 + 1 + 2
    # The attention layer's combine: a maximum and a sum over model.
    hq = cfg.n_heads
    assert sum(c.kind == "all-reduce" and c.axis == "model"
               and c.bytes in (b * hq * 4, b * hq * (cfg.resolved_head_dim
                                                     + 1) * 4)
               for c in seen) == 2
