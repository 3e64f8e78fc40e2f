"""The sharded serve path: one client split over a mesh of gloo ranks on
the CPU ((2, 2) or (1, 2) ("data", "model"), the (1, 2) meshes the first
ranks of the (2, 2), ``launch.mesh.sub_mesh``), against the reference's
unsharded ``prefill``/``decode_step``/``forward`` on the same numpy
weights; and the dry-run per card of the reference's production meshes.

* Reduced jamba-v0.1-52b (hybrid: attention, Mamba-2, MoE) and reduced
  qwen3-moe-235b-a22b (4 experts, 2 kv heads), f32, policy ``fsdp_tp``,
  MoE through ``make_ep_dispatch``, dropless (``capacity_factor = E / k``,
  so local routing is global routing), the residual stream split over the
  sequence on ``model`` (the large archs' plan); on both meshes.
* Reduced qwen3-0.6b under ``tp`` (the stream whole, each split product
  all-reduced) with 1 kv head (``n_kv_heads % |model| != 0``: each rank
  takes its query heads' kv head from the whole ``wk``/``wv``), and with a
  vocabulary of 250 padded to 256 (the vocabulary-split head masks the pad
  by global column); reduced granite-moe-3b-a800m under ``tp``, each
  expert's ``F`` split over ``model`` (no dispatch).
* Reduced mamba2-2.7b under ``tp`` on (2, 2) and under ``fsdp_tp`` (the
  stream split over the sequence) on (1, 2), and with 2 groups of ``B``/
  ``C`` on (1, 2) (each rank's heads read one group): every Mamba mixer
  split by heads.  Reduced jamba with one Mamba head (``ssm_head_dim``
  128: the mixer computed whole), and with a cache of twice the sequence,
  so that every position lies in rank 0's slots and rank 1's are masked
  in every decode step; reduced whisper-base under ``tp`` (its cross-
  attention's frames split over ``model``, the flash-decode combine).
* Reduced qwen3-moe under ``fsdp_tp`` on (1, 2) without the dispatch,
  its config carrying the ``act_shard_moe`` split as the plan sets it:
  each rank routes every token and computes its 2 of the 4 experts, the
  ranks' contributions reduce-scattered over the sequence.
* 4 sequences of 12 prompt tokens and 2 decode steps, each rank holding
  its shards of the weights, its sequences and its shard of the cache;
  attention, MLPs, Mamba mixers, embedding and head split over ``model``
  (each rank's logits its slice of the vocabulary, gathered by
  ``lm.gather_logits``), a decode step attending over the rank's slots of
  the cache.
  Logits within 1e-5 of the reference's; each rank's parameter bytes those
  of the specs.
* ``--mesh pod``/``multipod``: one card's parameter bytes for one serve
  cell per family equal the reference's ``NamedSharding.shard_shape``
  arithmetic on its (16, 16) and (2, 16, 16) meshes (a subprocess with
  512 host devices) — exact.
"""

import json
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import _torch_mesh_ranks as ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_arch as tget  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    filtered_specs, local_shape, make_sharding_rules, tree_paths)
from repro_torch.launch import dryrun, report  # noqa: E402
from repro_torch.launch import plan as tplan  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_on_mesh  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

# (id, arch, mesh, policy, the stream split over the sequence, the
# dispatch, config overrides on top of the reduced arch)
CASES = [
    ("jamba-fsdp_tp", "jamba-v0.1-52b", (2, 2), "fsdp_tp", True, True, {}),
    ("qwen3-moe-fsdp_tp", "qwen3-moe-235b-a22b", (2, 2), "fsdp_tp", True,
     True, {}),
    ("jamba-fsdp_tp-1x2", "jamba-v0.1-52b", (1, 2), "fsdp_tp", True, True,
     {}),
    ("qwen3-moe-fsdp_tp-1x2", "qwen3-moe-235b-a22b", (1, 2), "fsdp_tp", True,
     True, {}),
    ("qwen3-tp-kv1", "qwen3-0.6b", (2, 2), "tp", False, False,
     {"n_kv_heads": 1}),
    ("qwen3-fsdp_tp-kv1-1x2", "qwen3-0.6b", (1, 2), "fsdp_tp", True, False,
     {"n_kv_heads": 1}),
    ("qwen3-tp-vocab250", "qwen3-0.6b", (2, 2), "tp", False, False,
     {"vocab_size": 250}),
    ("granite-moe-tp", "granite-moe-3b-a800m", (2, 2), "tp", False, False,
     {}),
    ("mamba2-tp", "mamba2-2.7b", (2, 2), "tp", False, False, {}),
    ("mamba2-fsdp_tp-1x2", "mamba2-2.7b", (1, 2), "fsdp_tp", True, False,
     {}),
    ("mamba2-tp-2groups-1x2", "mamba2-2.7b", (1, 2), "tp", False, False,
     {"ssm_groups": 2}),
    ("jamba-fsdp_tp-1x2-mamba-whole", "jamba-v0.1-52b", (1, 2), "fsdp_tp",
     True, True, {"ssm_head_dim": 128}),
    ("jamba-fsdp_tp-1x2-rank0-slots", "jamba-v0.1-52b", (1, 2), "fsdp_tp",
     True, True, {}),
    ("whisper-tp", "whisper-base", (2, 2), "tp", False, False, {}),
    ("qwen3-moe-fsdp_tp-1x2-expert-split", "qwen3-moe-235b-a22b", (1, 2),
     "fsdp_tp", True, False, {}),
]
# The cases whose config carries the act_shard_moe split.
EXPERT_SPLIT = {"qwen3-moe-fsdp_tp-1x2-expert-split"}
# A cache longer than the prompt and its decode steps, so that every
# position lies in rank 0's slots and rank 1's are all masked: the weights,
# tokens and reference logits of the case named (masked slots add exactly
# 0 to the reference's softmax, so its logits do not depend on the cache's
# length).
LONG_CACHE = {"jamba-fsdp_tp-1x2-rank0-slots": ("jamba-fsdp_tp-1x2", 28)}
IDS = [c[0] for c in CASES]
ARCHS = [c[1] for c in CASES]
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT, TOTAL = 12, 14
# One serve cell per family.
FAMILY_CELLS = [("qwen3-0.6b", "decode_32k"), ("command-r-plus-104b",
                                               "prefill_32k"),
                ("mamba2-2.7b", "long_500k"), ("granite-moe-3b-a800m",
                                               "decode_32k"),
                ("qwen3-moe-235b-a22b", "prefill_32k"),
                ("jamba-v0.1-52b", "long_500k"), ("whisper-base",
                                                  "decode_32k"),
                ("internvl2-26b", "prefill_32k")]

REFERENCE_BYTES = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.launch import plan as jplan
out = {}
devs = np.array(jax.devices())
for kind, shape, axes in (("pod", (16, 16), ("data", "model")),
                          ("multipod", (2, 16, 16), ("pod", "data", "model"))):
    mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), axes)
    for arch, cell in json.loads(sys.argv[1]):
        plan = jplan.make_plan(arch, cell, mesh)
        sh = jplan.sharding_specs(plan, mesh)
        total = 0
        for ns, leaf in zip(jax.tree.leaves(sh["params"]),
                            jax.tree.leaves(sh["params_shapes"])):
            total += int(np.prod(ns.shard_shape(leaf.shape))) \
                * leaf.dtype.itemsize
        out[f"{kind}/{arch}/{cell}"] = total
print(json.dumps(out))
"""


def _cfg_kw(i):
    base = replace(jconfigs.get_arch(ARCHS[i]).reduced(), **CASES[i][6])
    kw = dict(CASES[i][6])
    if base.moe:
        kw.update(capacity_factor=base.n_experts / base.top_k,
                  moe_impl="scatter")
    return kw


@pytest.fixture(scope="module")
def cases():
    """Per case: the reference's weights (numpy), tokens, and its logits of
    prefill + decode and of forward."""
    out = []
    for i, arch in enumerate(ARCHS):
        if IDS[i] in LONG_CACHE:
            same, max_len = LONG_CACHE[IDS[i]]
            assert CASES[i][1:] == CASES[IDS.index(same)][1:]
            out.append(dict(out[IDS.index(same)], max_len=max_len))
            continue
        kw = _cfg_kw(i)
        jcfg = replace(jconfigs.get_arch(arch).reduced(), **kw)
        params = jlm.init_params(jax.random.key(i), jcfg)
        rng = np.random.default_rng(7 + i)
        toks = rng.integers(0, jcfg.vocab_size, (4, TOTAL)).astype(np.int32)
        extra = {}
        if jcfg.frontend == "audio":            # whisper's frame stub
            extra["frames"] = rng.standard_normal(
                (4, jcfg.frontend_len, jcfg.d_model)).astype(np.float32)
        jextra = {k: jnp.asarray(v) for k, v in extra.items()}
        logits, cache = jlm.prefill(params, {"tokens": jnp.asarray(
            toks[:, :PROMPT]), **jextra}, jcfg, max_len=TOTAL)
        steps = [np.asarray(logits)]
        for t in range(PROMPT, TOTAL):
            logits, cache = jlm.decode_step(params, cache, jnp.asarray(
                toks[:, t:t + 1]), jnp.int32(t), jcfg)
            steps.append(np.asarray(logits))
        fwd = jlm.forward(params, {"tokens": jnp.asarray(toks), **jextra},
                          jcfg)
        _, _, mesh, policy, seq, dispatch, _ = CASES[i]
        out.append({"arch": arch, "cfg": kw, "mesh": mesh, "policy": policy,
                    "seq": seq, "dispatch": dispatch,
                    "expert_split": IDS[i] in EXPERT_SPLIT,
                    "params": jax.tree.map(np.asarray, params),
                    "tokens": toks, "prompt": PROMPT, "max_len": TOTAL,
                    "extra": extra,
                    "ref_steps": np.stack(steps, axis=1),
                    "ref_forward": np.asarray(fwd)})
    return out


@pytest.fixture(scope="module")
def served(cases):
    send = [{k: c[k] for k in ("arch", "cfg", "mesh", "policy", "seq",
                               "dispatch", "expert_split", "params",
                               "tokens", "prompt",
                               "max_len", "extra")}
            for c in cases]
    res = run_on_mesh(ranks.serve_rank, (2, 2), ("data", "model"),
                      backend="gloo", device="cpu", args=(send,),
                      timeout_s=300)
    return [[r[i] for r in res if r[i] is not None]
            for i in range(len(CASES))]


def _batch(served, i, key):
    """The whole batch's logits: data shards in order, each model rank's
    copy equal."""
    ranks_ = {r["coords"]: r for r in served[i]}
    for (d, m), r in ranks_.items():
        assert torch.equal(r[key], ranks_[(d, 0)][key])
    return np.concatenate([ranks_[(d, 0)][key].numpy()
                           for d in range(CASES[i][2][0])])


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_sharded_prefill_decode_match_reference(i, cases, served):
    got = _batch(served, i, "steps")
    ref = cases[i]["ref_steps"]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_sharded_forward_matches_reference(i, cases, served):
    np.testing.assert_allclose(_batch(served, i, "forward"),
                               cases[i]["ref_forward"], **TOL)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_rank_parameter_bytes_are_the_specs(i, cases, served):
    """Each rank holds exactly its shards: the bytes the filtered specs
    give; under ``fsdp_tp`` on (2, 2), under a quarter of the whole plus
    the replicated leaves."""
    _, arch, mesh, policy, _, _, _ = CASES[i]
    cfg = replace(tget(arch).reduced(), **cases[i]["cfg"])
    ax = dict(zip(("data", "model"), mesh))
    rules = make_sharding_rules(policy, ax, fl_axes=())
    shapes = tlm.param_shapes(cfg)
    specs = dict(tree_paths(filtered_specs(rules["params"].tree_specs(
        shapes), shapes, ax)))
    want = sum(int(np.prod(local_shape(shape, specs[path], ax)))
               * torch.empty((), dtype=dtype).element_size()
               for path, shape, dtype in tplan.param_leaves(cfg))
    whole = tplan.param_bytes(cfg)
    assert len(served[i]) == int(np.prod(mesh))
    for r in served[i]:
        assert r["param_bytes"] == want
    assert whole / np.prod(mesh) <= want < whole
    if (policy, mesh) == ("fsdp_tp", (2, 2)):
        assert want < whole / 2


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_each_rank_computes_its_vocabulary_slice(i, served):
    """Each rank's ``forward`` returns its slice of the padded vocabulary
    (the whole back through ``lm.gather_logits``); the split products are
    summed over ``model`` (all-reduced under ``tp``, reduce-scattered over
    the sequence under sequence parallelism)."""
    _, arch, mesh, policy, seq, _, kw = CASES[i]
    cfg = replace(tget(arch).reduced(), **kw)
    for r in served[i]:
        assert r["local_vocab"] == cfg.padded_vocab // mesh[1]
        assert ("all-reduce", "model") in r["collectives"]
        assert (("reduce-scatter", "model") in r["collectives"]) == seq


def test_decode_slots_lie_where_the_cache_splits_them(served):
    """Each rank holds the written slots of its block of the cache: on
    (1, 2) with a cache of the prompt and its steps each rank half of
    them, and with one of twice that length all on rank 0 (rank 1's block
    fully masked in every decode step's attention)."""
    for case, want in (("jamba-fsdp_tp-1x2", {(0, 0): 7, (0, 1): 7}),
                       ("jamba-fsdp_tp-1x2-rank0-slots",
                        {(0, 0): TOTAL, (0, 1): 0})):
        got = {r["coords"]: r["slots_held"] for r in served[IDS.index(case)]}
        assert got == want, case


@pytest.fixture(scope="module")
def reference_card_bytes():
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", REFERENCE_BYTES,
                          json.dumps(FAMILY_CELLS)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["pod", "multipod"])
@pytest.mark.parametrize("arch,cell", FAMILY_CELLS,
                         ids=[a for a, _ in FAMILY_CELLS])
def test_card_param_bytes_match_reference_shard_shape(arch, cell, kind,
                                                      reference_card_bytes):
    mesh = make_mesh((16, 16) if kind == "pod" else (2, 16, 16),
                     ("data", "model") if kind == "pod"
                     else ("pod", "data", "model"), backend="meta")
    plan = tplan.make_plan(arch, cell, mesh)
    assert tplan.param_bytes_per_card(plan, mesh) == \
        reference_card_bytes[f"{kind}/{arch}/{cell}"]


def test_mesh_pod_counts_a_cell_per_card(tmp_path):
    """A pod serve cell is counted on one card's shards: its record's
    per-card parameter bytes, the collectives the step ran (their wire
    bytes over the NVLink rate are ``collective_s``), per-card ``fits``;
    a train cell is counted too (jamba's one period, one local step of
    the same global batch: its gathers, the re-gathers under remat and
    the gradient reductions); ``--mesh one``
    records keep no mesh keys and a zero collective term."""
    rec = dryrun.run_cell("jamba-v0.1-52b", "decode_32k", mesh="pod")
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["moe_dispatch"] and rec["policy"] == "fsdp_tp"
    plan = tplan.make_plan("jamba-v0.1-52b", "decode_32k",
                           make_mesh((16, 16), ("data", "model"),
                                     backend="meta"))
    assert rec["param_bytes_per_card"] == tplan.param_bytes_per_card(
        plan, {"data": 16, "model": 16})
    assert rec["param_bytes_per_card"] < rec["param_bytes"] / 100
    coll = rec["collectives"]
    assert coll["by_kind"]["all-gather"]["count"] > 0
    # The 16 MoE layers' dispatch (over model, and the aux term over
    # data), and the split products' sums over model: 4 attention layers,
    # 16 dense MLPs, the embedding, 28 Mamba mixers (each with its gated
    # norm's sum of squares); the 4 attention layers' flash-decode combine
    # (a maximum and a sum each).
    assert coll["by_kind"]["all-reduce"]["count"] == \
        2 * 16 + 4 + 16 + 1 + 2 * 28 + 2 * 4
    assert rec["roofline"]["collective_s"] == pytest.approx(
        coll["wire_bytes_ici"] / rec["hw"]["link_bw"])
    assert rec["fits"] == (rec["memory_analysis"]["peak_live_bytes"]
                           <= rec["budget_bytes"])
    assert rec["kernels"] == {}              # decode launches no kernel
    train = dryrun.run_cell("jamba-v0.1-52b", "train_4k", mesh="pod",
                            overrides={"n_layers": 8, "S": 1, "b": 256})
    assert train["status"] == "ok" and train["kind"] == "train"
    assert train["policy"] == "fsdp_tp" and train["moe_dispatch"]
    assert train["roofline"]["collective_s"] > 0
    tcoll = train["collectives"]["by_kind"]
    assert tcoll["all-gather"]["count"] > 0 and tcoll["all-reduce"]["count"] \
        > 0
    one = dryrun.run_cell("qwen3-0.6b", "decode_32k",
                          overrides={"n_layers": 2})
    assert "mesh" not in one and "collectives" not in one
    assert one["roofline"]["collective_s"] == 0.0
    for r in (rec, train, one):
        with open(tmp_path / f"{r['arch']}__{r['shape']}__x.json", "w") as f:
            json.dump(r, f)
    table = report.roofline_table(report.load(str(tmp_path)))
    assert "collective_s" in table and "decode_32k @ pod" in table
    assert "train_4k @ pod" in table


def test_train_step_on_a_mesh_is_the_next_slice():
    """The train step binds to a rank's blocks on a meta (2, 2) mesh: its
    shards of θ, its workers' ``[W_r, P, S, b_r, s]`` block of the
    batches and its ``[W_r, P, S]`` masks (qwen3-0.6b ``tp``: one of two
    workers over ``data``, the whole batch of its lane; qwen3-moe
    ``fsdp_tp``: the one worker, half its batch over ``data``)."""
    from repro_torch.distributed.sharding import tree_paths
    mesh = make_mesh((2, 2), ("data", "model"), backend="meta")
    for arch, block in (("qwen3-0.6b", (1, 1, 4, 32, 4096)),
                        ("qwen3-moe-235b-a22b", (1, 1, 8, 16, 4096))):
        plan = tplan.make_plan(arch, "train_4k", mesh)
        fn, (params, batches, step_mask, boundary, weight) = build_step(
            plan, "meta", mesh=mesh)
        assert callable(fn)
        specs = dict(tree_paths(tplan.sharding_specs(plan, mesh)["params"]))
        shapes = dict(tree_paths(tlm.param_shapes(plan.cfg)))
        assert set(params) == set(specs)
        for path, leaf in params.items():
            assert tuple(leaf.shape) == local_shape(shapes[path],
                                                    specs[path], mesh)
        assert sum(x.numel() * x.element_size() for x in params.values()) \
            == tplan.param_bytes_per_card(plan, mesh)
        assert tuple(batches["tokens"].shape) == block
        for m in (step_mask, boundary, weight):
            assert tuple(m.shape) == block[:3]
