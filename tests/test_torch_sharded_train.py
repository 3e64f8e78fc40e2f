"""The sharded training step: one federated round of one client split over
a mesh of gloo ranks on the CPU ((2, 2) ("data", "model"), or the first
ranks of it laid out as (2, 1) or (1, 2), ``launch.mesh.sub_mesh``, or
all four as (2, 1, 2) ("pod", "data", "model")), against the
reference's unsharded ``repro.fl.round.make_round_step(make_loss_fn(cfg),
sgd(0.05, 0.9))`` on the same numpy weights and batches.

Each case is the reference's ``train_4k`` plan of the full arch on that
mesh, cut to the arch's reduced widths (f32), ``S = 2`` steps of ``b = 4``
sequences of 16 tokens, two clients a lane (a boundary at step 0 and at
step 1, integer weights), loss chunks of 8:

* qwen3-0.6b, ``tp``: two workers over ``data`` (``W = 2``, one lane
  each), each worker's layers split over ``model`` (its heads, MLP
  columns and vocabulary; each split product all-reduced over ``model``);
  the same with 1 kv head (each rank takes its query heads' kv head from
  the whole ``wk``/``wv``) and a vocabulary of 250 padded to 256 (the
  vocabulary-parallel CE masks the pad by global column); and on (2, 1),
  where ``model`` splits nothing;
* granite-moe-3b-a800m, ``tp``: each expert's ``F`` split over ``model``
  (no dispatch), every rank routing the same tokens;
* qwen3-moe-235b-a22b, ``fsdp_tp``: one worker over the whole mesh, its
  batch split over ``data``, its parameters over ``(data, model)``, the
  residual stream over the sequence on ``model`` (sequence parallelism),
  its MoE layers through the expert-parallel dispatch (dropless,
  ``moe_impl="scatter"``).  The dispatch routes each data shard on its own
  and averages the shards' load-balance terms (the reference's dispatch
  does the same), which is not the whole batch's term: against the
  unsharded round this case sets ``moe_aux_weight = 0``;
* the same plan without the dispatch (``moe_dispatch=None``): each rank
  gathers the batch's tokens for the routing and, under the plan's
  ``act_shard_moe`` split, computes its 2 of the 4 experts (gathered over
  ``data`` only), the ranks' contributions summed over ``model``, so the
  load-balance term is the whole batch's and stays on; the same with 3
  experts at capacity 1.5 (64 rows an expert: each rank its 32 rows of
  every expert) and, on (1, 2), at capacity 2.0 (85 rows: neither divides,
  rank 0 computes the layer);
* the reference's multipod regime: the same arch's ``train_4k`` plan on
  (2, 1, 2) ("pod", "data", "model"), two workers over ``pod`` (so no
  dispatch), each split over ``model`` under the ``act_shard_moe`` split;
* the same plan with the batch replicated over ``data`` (``batch_axes=
  ()``), the dispatch and the load-balance term on: ``data`` is then an
  FSDP axis that splits no data;
* the same at capacity 0.75, where the 4 experts are offered ~32 slots
  each against a capacity of 24: the dispatch and the reference's
  unsharded layer route the same group of tokens (the whole batch, shorter
  than either's sequence block), so they drop the same ones;
* qwen3-0.6b ``tp`` and qwen3-moe ``fsdp_tp`` with a gradient clip that
  binds: the global norm is taken over the ranks' shards.

Tolerances: the new global parameters (gathered from the ranks' shards)
and the round's loss within 1e-5 of the reference's; steps, clients and
total weight exact.  On (2, 1) the ``tp`` round equals the port's own
unsharded round bitwise (each rank computes its worker's lane with the
same operations; no sum is re-associated at two lanes), with its
cross-worker reduce taken in many column chunks; on (2, 2) it is within
1e-5 of it (a row-parallel product sums over ``model`` in another
order).  A loss through ``gather_leaf`` gives the one-process gradient
under the training rule, and twice it (``|model|``) under the serve
convention's summing gather.
"""

import math
import time
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import _torch_mesh_ranks as ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import core as _jcore  # noqa: E402,F401  (before repro.fl)
from repro.fl.round import make_round_step as jround_step  # noqa: E402
from repro.models import make_loss_fn as jmake_loss_fn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.distributed.sharding import tree_paths  # noqa: E402
from repro_torch.fl.round import make_round_step as tround_step  # noqa: E402
from repro_torch.kernels.layout import flatten_tree  # noqa: E402
from repro_torch.launch import plan as tplan  # noqa: E402
from repro_torch.launch.mesh import run_on_mesh  # noqa: E402
from repro_torch.models import (lm_params_from_numpy,  # noqa: E402
                                make_lane_loss_fn)
from repro_torch.optim import sgd as tsgd  # noqa: E402

AXES = {"data": 2, "model": 2}
S, B, SEQ = 2, 4, 16
TOL = dict(rtol=1e-5, atol=1e-5)
MOE = {"loss_chunk": 8, "moe_impl": "scatter", "capacity_factor": 2.0}
CLIP = 0.5
# (id, arch, knobs, plan overrides, mesh, gradient clip)
CASES = [
    ("qwen3-tp", "qwen3-0.6b", {"loss_chunk": 8}, None, (2, 2), None),
    ("qwen3-moe-fsdp_tp-dispatch", "qwen3-moe-235b-a22b",
     dict(MOE, moe_aux_weight=0.0), None, (2, 2), None),
    ("qwen3-moe-fsdp_tp-gathered-routing", "qwen3-moe-235b-a22b",
     dict(MOE, moe_dispatch=None), None, (2, 2), None),
    ("qwen3-moe-fsdp_tp-batch-replicated", "qwen3-moe-235b-a22b", MOE,
     {"batch_axes": ()}, (2, 2), None),
    ("qwen3-moe-fsdp_tp-drops", "qwen3-moe-235b-a22b",
     dict(MOE, capacity_factor=0.75), {"batch_axes": ()}, (2, 2), None),
    ("qwen3-tp-2x1", "qwen3-0.6b", {"loss_chunk": 8}, None, (2, 1), None),
    ("qwen3-tp-kv1-vocab250", "qwen3-0.6b",
     {"loss_chunk": 8, "n_kv_heads": 1, "vocab_size": 250}, None, (2, 2),
     None),
    ("granite-moe-tp", "granite-moe-3b-a800m", MOE, None, (2, 2), None),
    ("qwen3-tp-clip", "qwen3-0.6b", {"loss_chunk": 8}, None, (2, 2), CLIP),
    ("qwen3-moe-fsdp_tp-clip", "qwen3-moe-235b-a22b",
     dict(MOE, moe_aux_weight=0.0), None, (2, 2), CLIP),
    ("mamba2-tp", "mamba2-2.7b", {"loss_chunk": 8}, None, (2, 2), None),
    ("jamba-fsdp_tp-gathered-routing", "jamba-v0.1-52b",
     dict(MOE, moe_dispatch=None), None, (2, 2), None),
    ("qwen3-moe-multipod-gathered-routing", "qwen3-moe-235b-a22b", MOE,
     None, (2, 1, 2), None),
    ("qwen3-moe-fsdp_tp-gathered-routing-capacity", "qwen3-moe-235b-a22b",
     dict(MOE, moe_dispatch=None, n_experts=3, capacity_factor=1.5), None,
     (2, 2), None),
    ("qwen3-moe-fsdp_tp-gathered-routing-whole-1x2", "qwen3-moe-235b-a22b",
     dict(MOE, moe_dispatch=None, n_experts=3), None, (1, 2), None),
]
MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
# The Mamba gradient probe: (arch, knobs) on (1, 2), the mixers split by
# heads with the stream whole (mamba2, ``tp``) and split over the
# sequence (jamba, ``fsdp_tp``).
GRAD_CASES = [("mamba2-2.7b", {"loss_chunk": 8}),
              ("jamba-v0.1-52b", dict(MOE, moe_dispatch=None))]
MAMBA_LEAVES = ("mamba_norm", "mamba_in", "mamba_conv", "mamba_A",
                "mamba_dt_bias", "mamba_D", "mamba_gnorm", "mamba_out")
IDS = [c[0] for c in CASES]
# The reference config takes the plan's knobs (not its hooks) and the
# cases' widths.
KNOBS = ("attn_impl", "attn_q_chunk", "attn_repeat_kv", "moe_impl",
         "moe_seq_chunk", "remat", "loss_chunk", "capacity_factor",
         "moe_aux_weight", "n_kv_heads", "vocab_size", "n_experts")


def _axes_of(i):
    return dict(zip(MESH_AXES[len(CASES[i][4])], CASES[i][4]))


def _plan(i):
    _, arch, knobs, overrides, _, _ = CASES[i]
    return ranks.train_plan(_axes_of(i), arch, S=S, b=B, knobs=knobs,
                            overrides=overrides)


@pytest.fixture(scope="module")
def cases():
    """Per case: the numpy weights, batches and masks, and the
    reference's new params and metrics."""
    out = []
    for i, (_, arch, knobs, overrides, mesh, clip) in enumerate(CASES):
        plan = _plan(i)
        red = jconfigs.get_arch(arch).reduced()
        jcfg = replace(red, **{k: getattr(plan.cfg, k) for k in KNOBS})
        params = jax.tree.map(np.asarray,
                              jlm.init_params(jax.random.key(i), jcfg))
        W, P = plan.W, plan.P
        rng = np.random.default_rng(11 + i)
        tokens = rng.integers(0, jcfg.vocab_size,
                              (W, P, S, B, SEQ)).astype(np.int32)
        step_mask = np.ones((W, P, S), np.float32)
        boundary = np.ones((W, P, S), np.float32)
        weight = np.arange(1.0, W * P * S + 1, dtype=np.float32).reshape(
            W, P, S)
        jnew, jm = jax.jit(jround_step(jmake_loss_fn(jcfg),
                                       jsgd(0.05, 0.9), grad_clip=clip))(
            jax.tree.map(jnp.asarray, params), {"tokens": jnp.asarray(
                tokens)}, *(jnp.asarray(a) for a in (step_mask, boundary,
                                                    weight)))
        out.append({
            "arch": arch, "knobs": knobs, "overrides": overrides,
            "mesh": mesh, "axes": MESH_AXES[len(mesh)], "grad_clip": clip,
            "S": S,
            "b": B, "params": params, "batches": {"tokens": tokens},
            "step_mask": step_mask, "boundary": boundary, "weight": weight,
            "ref_params": {k: np.asarray(v) for k, v in flatten_tree(
                jax.tree.map(np.asarray, jnew)).items()},
            "ref_metrics": {k: float(getattr(jm, k)) for k in jm._fields}})
    return out


def _grad_cases():
    """Per gradient case: the numpy weights of the reduced arch and 4
    sequences of 16 tokens."""
    out = []
    for i, (arch, knobs) in enumerate(GRAD_CASES):
        plan = ranks.train_plan(AXES, arch, S=1, b=B, knobs=knobs)
        red = jconfigs.get_arch(arch).reduced()
        jcfg = replace(red, **{k: getattr(plan.cfg, k) for k in KNOBS})
        params = jax.tree.map(np.asarray,
                              jlm.init_params(jax.random.key(40 + i), jcfg))
        tokens = np.random.default_rng(40 + i).integers(
            0, jcfg.vocab_size, (B, SEQ)).astype(np.int32)
        out.append({"arch": arch, "knobs": knobs, "params": params,
                    "tokens": tokens})
    return out


def _probe():
    rng = np.random.default_rng(5)
    return {"w": rng.standard_normal((8, 6)).astype(np.float32),
            "v": rng.standard_normal(6).astype(np.float32),
            "x": rng.standard_normal((4, 8)).astype(np.float32)}


# When run_on_mesh's ``meanwhile`` returned in ``trained``.
MEANWHILE_DONE = []


def _meanwhile():
    time.sleep(0.5)                     # the ranks are starting meanwhile
    MEANWHILE_DONE.append(time.time())


@pytest.fixture(scope="module")
def trained(cases):
    send = [{k: c[k] for k in ("arch", "knobs", "overrides", "mesh", "axes",
                               "grad_clip", "S", "b", "params", "batches",
                               "step_mask", "boundary", "weight")}
            for c in cases]
    res = run_on_mesh(ranks.train_rank, (2, 2), ("data", "model"),
                      backend="gloo", device="cpu",
                      args=(send, _probe(), _grad_cases()),
                      timeout_s=300, meanwhile=_meanwhile)
    return {r["coords"]: r for r in res}


def test_ranks_start_after_meanwhile(trained):
    """``run_on_mesh(meanwhile=)`` calls it once, and no rank enters its
    body before it has returned."""
    assert len(MEANWHILE_DONE) == 1
    assert all(r["started"] >= MEANWHILE_DONE[0] for r in trained.values())


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else (entry or ())


def _case(trained, i):
    """Case ``i``'s results by the rank's coords on its mesh."""
    return {r["cases"][i]["coords"]: r["cases"][i] for r in trained.values()
            if r["cases"][i] is not None}


def _assemble(trained, i):
    """The whole new parameters from the ranks' shards under the plan's
    specs."""
    axes = _axes_of(i)
    specs = dict(tree_paths(tplan.sharding_specs(_plan(i), axes)["params"]))
    ranks_ = _case(trained, i)
    out = {}
    for path, spec in specs.items():
        blocks = {c: r["params"][path].numpy() for c, r in ranks_.items()}
        local = blocks[min(blocks)]
        spec = tuple(spec) + (None,) * (local.ndim - len(spec))
        whole = np.zeros([n * math.prod(axes[a] for a in _axes(e))
                          for n, e in zip(local.shape, spec)], local.dtype)
        for c, x in blocks.items():
            coords = dict(zip(axes, c))
            sl = []
            for n, entry in zip(x.shape, spec):
                idx = 0
                for a in _axes(entry):
                    idx = idx * axes[a] + coords[a]
                sl.append(slice(idx * n, (idx + 1) * n))
            whole[tuple(sl)] = x
        out[path] = whole
    return out


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_sharded_round_matches_reference(i, cases, trained):
    got = _assemble(trained, i)
    ref = cases[i]["ref_params"]
    assert set(got) == set(ref)
    moved = 0.0
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **TOL)
        moved += float(np.abs(v - np.asarray(flatten_tree(
            cases[i]["params"])[k])).sum())
    assert moved > 0
    want = cases[i]["ref_metrics"]
    for r in _case(trained, i).values():
        m = {k: float(v) for k, v in r["metrics"].items()}
        np.testing.assert_allclose(m["loss"], want["loss"], **TOL)
        for k in ("steps", "clients", "total_weight"):
            assert m[k] == want[k], k


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_rank_holds_its_shards_and_folds_them(i, trained):
    """Each rank's parameter bytes are the plan's per-card bytes, and K1
    folds each dtype group once a local step on the rank's ``[L_r,
    n_g]`` shard buffer."""
    plan = _plan(i)
    axes = _axes_of(i)
    per_card = tplan.param_bytes_per_card(plan, axes)
    n_local = per_card // 4                       # f32, one group
    ranks_ = _case(trained, i)
    assert len(ranks_) == math.prod(CASES[i][4])
    for c in ranks_.values():
        assert c["param_bytes"] == per_card
        lanes = plan.W * plan.P // math.prod(axes[a]
                                             for a in plan.worker_axes)
        assert c["folds"] == [(lanes, n_local)] * S
    first = ranks_[min(ranks_)]
    policy, worker_axes, batch_axes, W, P = first["regime"]
    if policy == "tp":
        assert (worker_axes, W, P) == (("data",), 2, 1)
        # Split over model (where it has two ranks), norms replicated.
        assert tplan.param_bytes(plan.cfg) / axes["model"] <= per_card \
            <= tplan.param_bytes(plan.cfg)
    else:
        pods = axes.get("pod", 1)
        assert (policy, W, P) == ("fsdp_tp", pods, 1)
        assert worker_axes == (("pod",) if pods > 1 else ())
        assert batch_axes == (("data",) if CASES[i][3] is None else ())
        assert first["dispatch"] == ("gathered" not in IDS[i])
        # The plan sets act_shard_moe for every MoE arch on a mesh.
        assert first["expert_split"]
        assert per_card < tplan.param_bytes(plan.cfg) / (
            2 if axes["data"] > 1 else 1)


def _port_round(c, plan):
    """The port's one-process round of case ``c`` on one thread, as each
    rank runs (and as fast: the reduced round's small ops contend for this
    host's cores)."""
    params = flatten_tree(lm_params_from_numpy(c["params"], device="cpu"))
    step = tround_step(make_lane_loss_fn(plan.cfg), tsgd(0.05, 0.9),
                       grad_clip=c["grad_clip"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return step(params, {"tokens": torch.from_numpy(c["batches"][
            "tokens"])}, *(torch.from_numpy(c[k]) for k in ("step_mask",
                                                           "boundary",
                                                           "weight")))
    finally:
        torch.set_num_threads(threads)


def test_tp_mesh_round_equals_port_round_bitwise(cases, trained):
    """On (2, 1) (workers over ``data``, ``model`` of one rank: nothing is
    split) each rank runs the one-process lane's operations."""
    i = IDS.index("qwen3-tp-2x1")
    new, m = _port_round(cases[i], _plan(i))
    got = _assemble(trained, i)
    for k, v in new.items():
        assert np.array_equal(got[k], v.numpy()), k
    for r in _case(trained, i).values():
        for k, v in r["metrics"].items():
            assert torch.equal(v, getattr(m, k)), k


def test_tp_mesh_round_matches_port_round(cases, trained):
    """On (2, 2) each worker's layers are split over ``model``: within
    1e-5 of the port's one-process round, not bitwise (the row-parallel
    products sum over ``model`` in another order, as the reference's
    do)."""
    i = IDS.index("qwen3-tp")
    new, m = _port_round(cases[i], _plan(i))
    got = _assemble(trained, i)
    for k, v in new.items():
        np.testing.assert_allclose(got[k], v.numpy(), err_msg=k, **TOL)
    for r in _case(trained, i).values():
        np.testing.assert_allclose(float(r["metrics"]["loss"]),
                                   float(m.loss), **TOL)


@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES) if c[5]],
                         ids=[c[0] for c in CASES if c[5]])
def test_mesh_clip_binds(i, cases):
    """The clip of the clip cases binds: the reference's round without it
    moves the parameters otherwise."""
    c = cases[i]
    free = next(j for j, d in enumerate(CASES)
                if d[1:5] == CASES[i][1:5] and d[5] is None)
    assert any(not np.allclose(cases[free]["ref_params"][k], v, **TOL)
               for k, v in c["ref_params"].items())


@pytest.mark.parametrize("rule", ["train", "serve"])
def test_gather_leaf_gradient_counts_the_batch_once(rule, trained):
    """``Σ_rows ((x W) ⊙ v)²`` with ``x`` split over ``data``, ``W``
    over ``(data, model)`` and ``v`` replicated: under the training rule
    each rank's gradients are its slices of the one-process gradient;
    the summing gather of the serve path counts the replicated ``model``
    ranks twice over (and leaves ``v`` the rank's own batch's)."""
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in
         _probe().items() if k != "x"}
    x = torch.from_numpy(_probe()["x"])
    (((x @ p["w"]) * p["v"]) ** 2).sum().backward()
    for (d, m), r in trained.items():
        g = r["gather_rule"][rule]
        w = p["w"].grad[4 * d:4 * d + 4, 3 * m:3 * m + 3]
        if rule == "train":
            torch.testing.assert_close(g["w"], w, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(g["v"], p["v"].grad, rtol=1e-6,
                                       atol=1e-6)
        else:
            torch.testing.assert_close(g["w"], 2 * w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", ranks.SUB_SHAPES)
def test_sub_mesh_lays_out_the_first_ranks(shape, trained):
    """``launch.mesh.sub_mesh`` on the (2, 2) mesh: its first
    ``prod(shape)`` ranks, row-major on ``shape``, each axis' group summing
    over exactly the ranks on its line; the other ranks get ``None``."""
    n = math.prod(shape)
    for (d, m), r in trained.items():
        rank, got = 2 * d + m, r["sub_meshes"][shape]
        if rank >= n:
            assert got is None
            continue
        coords = tuple(int(c) for c in np.unravel_index(rank, shape))
        assert got["coords"] == coords
        for i, axis in enumerate(("data", "model")):
            line = [int(np.ravel_multi_index(
                coords[:i] + (j,) + coords[i + 1:], shape))
                for j in range(shape[i])]
            assert got["sums"][axis] == sum(q + 1 for q in line), axis


@pytest.mark.parametrize("arch,chunk", [("qwen3-moe-235b-a22b", 0),
                                        ("jamba-v0.1-52b", 2048)])
def test_dispatch_routes_ep_seq_chunk_blocks(arch, chunk):
    """The pod train plan's dispatch routes blocks of ``ep_seq_chunk``
    (the whole sequence below 4,096-wide experts), not the config's
    ``moe_seq_chunk`` (512) that a MoE layer without it routes: where
    tokens are dropped the two are different functions, and a one-process
    round held against the mesh's must route the dispatch's blocks."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((16, 16), ("data", "model"), backend="meta")
    plan = tplan.make_plan(arch, "train_4k", mesh)
    assert plan.cfg.moe_dispatch.seq_chunk == tplan.ep_seq_chunk(
        plan.cfg) == chunk
    assert plan.cfg.moe_seq_chunk == 512


# (arch, overrides, policy, W, dispatch, mesh): the reference's three
# regimes of a train cell at pod, and its multipod MoE regime (workers over
# pod, no dispatch), cut in depth.
REGIMES = [("qwen3-0.6b", {"n_layers": 2}, "tp", 256, False, "pod"),
           ("internlm2-1.8b", {"n_layers": 2}, "tp", 16, False, "pod"),
           ("qwen3-moe-235b-a22b", {"n_layers": 1}, "fsdp_tp", 1, True,
            "pod"),
           ("qwen3-moe-235b-a22b", {"n_layers": 1}, "fsdp_tp", 2, False,
            "multipod")]


@pytest.mark.parametrize("arch,overrides,policy,W,dispatch,mesh", REGIMES,
                         ids=["per-chip", "tp", "fsdp_tp",
                              "fsdp_tp-multipod"])
def test_mesh_pod_counts_a_train_cell_per_regime(arch, overrides, policy, W,
                                                 dispatch, mesh):
    """A pod train cell of each regime is counted per card: K1 once a
    local step per dtype group, the gathers, a positive ``collective_s``;
    where ``model`` is no worker axis the split layers' sums over it
    (all-reduces, and under sequence parallelism reduce-scatters, which
    are also the FSDP gathers' gradient reductions over ``data``, and a
    whole kv projection's over ``model``).  At multipod, without the
    dispatch, the ``act_shard_moe`` split keeps each rank's experts: the
    largest payload all-gathered over ``model`` is the residual stream of
    the rank's sequences (an expert leaf gathered over ``model`` would be
    48 times that)."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, "train_4k", mesh=mesh, overrides=overrides)
    assert rec["status"] == "ok" and rec["kind"] == "train"
    assert (rec["policy"], rec["W"], rec["moe_dispatch"]) == (policy, W,
                                                              dispatch)
    assert rec["kernels"]["fedavg_accum"]["calls"] == 2 * rec["S"]
    kinds = rec["collectives"]["by_kind"]
    assert kinds["all-gather"]["count"] > 0
    assert ("all-reduce" in kinds) == (W < rec["devices"])
    # Under tp a kv projection taken whole (internlm2's 8 kv heads on 16
    # ranks) sums its gradient over model too.
    from repro_torch.configs import get_arch
    whole_kv = get_arch(arch).n_kv_heads % 16 != 0 and W < rec["devices"]
    assert ("reduce-scatter" in kinds) == (policy == "fsdp_tp" or whole_kv)
    assert rec["roofline"]["collective_s"] > 0
    assert rec["param_bytes_per_card"] < rec["param_bytes"] / 10
    if policy == "fsdp_tp":
        cfg = get_arch(arch)
        axes = rec["axes"]
        stream = rec["b"] // axes["data"] * 4096 * cfg.d_model * 2
        by_axis = rec["collectives"]["by_kind_axis"]
        assert by_axis["all-gather/model"]["max_bytes"] == stream


@pytest.mark.parametrize("g", range(len(GRAD_CASES)),
                         ids=[a for a, _ in GRAD_CASES])
def test_split_mamba_gradients_match_one_process(g, trained):
    """Every Mamba leaf's gradient on 2 ranks, assembled from the ranks'
    shards (a leaf the specs split over ``model`` from its blocks, a
    replicated one equal on both), within 1e-5 of the port's one-process
    gradient; the loss too.  The gated norm's sum of squares feeds each
    rank's own heads, so its all-reduce must sum the gradient as well: a
    ``psum`` whose backward passes the cotangent through gives each rank
    only its own heads' part of it, and ``mamba_in``, ``mamba_conv``,
    ``A``, ``dt_bias`` and ``D`` off by far more than this tolerance."""
    from repro_torch.launch.plan import sharding_specs
    case = _grad_cases()[g]
    arch, knobs = GRAD_CASES[g]
    plan = ranks.train_plan({"data": 1, "model": 2}, arch, S=1, b=B,
                            knobs=knobs)
    specs = dict(tree_paths(sharding_specs(plan, {"data": 1, "model": 2})[
        "lane"]["params"]))
    params = lm_params_from_numpy(case["params"], device="cpu")
    leaves = dict(tree_paths(params))
    for leaf in leaves.values():
        leaf.requires_grad_()
    from repro_torch.models import lm as tlm
    loss = tlm.loss_fn(params, {"tokens": torch.from_numpy(case["tokens"])},
                       plan.cfg, device="cpu")
    loss.backward()
    got = {r["coords"]: r["mamba_grads"][g] for r in trained.values()
           if r["mamba_grads"] is not None}
    assert sorted(got) == [(0, 0), (0, 1)]
    mamba = [k for k in leaves if "/mamba_" in k]
    assert {k.rsplit("/", 1)[1] for k in mamba} == set(MAMBA_LEAVES)
    for k in mamba:
        want = leaves[k].grad
        spec = tuple(specs[k]) + (None,) * (want.ndim - len(specs[k]))
        dims = [d for d, e in enumerate(spec) if "model" in _axes(e)]
        blocks = [got[(0, m)]["grads"][k] for m in (0, 1)]
        whole = torch.cat(blocks, dim=dims[0]) if dims else blocks[0]
        if not dims:
            np.testing.assert_allclose(blocks[1].numpy(), blocks[0].numpy(),
                                       err_msg=k, **TOL)
        np.testing.assert_allclose(whole.numpy(), want.numpy(), err_msg=k,
                                   **TOL)
    for r in got.values():
        np.testing.assert_allclose(float(r["loss"]), float(loss.detach()),
                                   **TOL)
