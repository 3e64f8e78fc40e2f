"""Rank bodies for the port's mesh tests: spawned by
``repro_torch.launch.mesh.run_on_mesh`` on gloo ranks on the CPU.

A module of its own, importing neither JAX nor pytest, so that a spawned
rank loads only the port.
"""

from __future__ import annotations

import time
from dataclasses import fields, replace

import torch

from repro_torch.configs import get_arch
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.ep_dispatch import make_ep_dispatch
from repro_torch.distributed.sharding import (ExpertSplit, filter_spec,
                                              filtered_specs,
                                              make_sharding_rules, shard_leaf,
                                              shard_tree)
from repro_torch.launch.mesh import axis_sizes
from repro_torch.launch.plan import cache_specs, make_plan
from repro_torch.models import lm, lm_params_from_numpy

GATE_SPEC = ("model", "data", None)          # [E, D, F]
DOWN_SPEC = ("model", None, "data")          # [E, F, D]


def ep_rank(mesh, arrays: dict, cases: list) -> dict:
    """The dispatch on this rank's shards of ``arrays`` (x, router, gate,
    up, down and the cotangent ``c``) for each case ``(cf, seq_chunk)``:
    out and aux, and the gradients of ``Σ out·c + aux`` (``"grad_aux"``)
    and of ``Σ out·c`` (``"grad_out"``) with respect to every input."""
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    specs = {"x": ("data",), "c": ("data",), "router": (), "gate": GATE_SPEC,
             "up": GATE_SPEC, "down": DOWN_SPEC}
    local = {k: shard_leaf(v, specs[k], mesh) for k, v in t.items()}
    results = []
    for cf, seq_chunk in cases:
        disp = make_ep_dispatch(mesh, batch_axes=("data",),
                                fsdp_axis="data", seq_chunk=seq_chunk)
        res = {}
        for loss in ("aux", "out"):
            ins = {k: local[k].clone().requires_grad_()
                   for k in ("x", "router", "gate", "up", "down")}
            out, aux = disp(ins["x"], ins["router"], ins["gate"], ins["up"],
                            ins["down"], top_k=2, capacity_factor=cf)
            total = (out * local["c"]).sum()
            (total + aux if loss == "aux" else total).backward()
            res[f"grad_{loss}"] = {k: v.grad for k, v in ins.items()}
        res.update(out=out.detach(), aux=aux.detach())
        results.append(res)
    return {"coords": mesh.coords, "cases": results,
            "collectives": _collectives(mesh)}


def _collectives(mesh) -> dict:
    """Each collective's value and gradient on this rank (see
    ``test_collective_gradients_count_a_loss_once``)."""
    d, m = mesh.coords
    x = torch.ones(3, requires_grad=True)
    coll.psum(x, mesh, "model").sum().backward()
    y = torch.ones(3, requires_grad=True)
    coll.pmean(y, mesh, "model").sum().backward()
    z = torch.full((2,), float(2 * d + m), requires_grad=True)
    g = coll.all_gather(z, mesh, "model", dim=0)
    (g * torch.arange(1.0, 5.0)).sum().backward()
    return {"psum_grad": x.grad, "pmean_grad": y.grad,
            "psum": coll.psum(torch.full((3,), float(d + m)), mesh, "model"),
            "gather": g.detach(), "gather_grad": z.grad}


def serve_specs(cfg, mesh, policy: str, b: int, max_len: int, *,
                seq: bool = True) -> dict:
    """A serve step's specs for ``cfg`` on ``mesh`` under ``policy``, as
    ``launch.plan.sharding_specs`` gives them for a prefill: the filtered
    parameter and cache specs, the residual stream split over ``data``
    and (with ``seq``) the sequence over ``model``, and the logits over
    the vocabulary."""
    ax = axis_sizes(mesh)
    rules = make_sharding_rules(policy, mesh, fl_axes=())
    shapes = lm.param_shapes(cfg)
    batch = filter_spec(("data",), (b,), ax)[0]
    return {"params": filtered_specs(rules["params"].tree_specs(shapes),
                                     shapes, mesh),
            "cache": cache_specs(cfg, rules, b, max_len, mesh),
            "act": (batch, "model" if seq else None, None),
            "logits": filter_spec((batch, "model"), (b, cfg.padded_vocab),
                                  ax)}


def serve_rank(mesh, cases: list) -> list:
    """Each case's reduced arch split over its mesh (the first ranks of
    ``mesh``, ``launch.mesh.sub_mesh``) under its policy, its MoE layers
    through ``make_ep_dispatch`` where it says so: this rank's prefill
    logits and decode-step logits (the whole vocabulary gathered), its
    ``forward`` logits, the bytes of its parameter shards and its
    collectives by kind and axis; None on a rank a case leaves out."""
    from repro_torch.launch.mesh import sub_mesh
    out = []
    for case in cases:
        sub = sub_mesh(mesh, case["mesh"])
        out.append(None if sub is None else _serve_case(sub, case))
    return out


def _serve_case(mesh, case: dict) -> dict:
    cfg = replace(get_arch(case["arch"]).reduced(), **case["cfg"])
    tokens = torch.from_numpy(case["tokens"])
    s, total = case["prompt"], tokens.shape[1]
    max_len = case.get("max_len", total)
    specs = serve_specs(cfg, mesh, case["policy"], tokens.shape[0], max_len,
                        seq=case["seq"])
    if case["dispatch"]:
        cfg = replace(cfg, moe_dispatch=make_ep_dispatch(
            mesh, batch_axes=("data",), fsdp_axis="data",
            seq_chunk=case.get("seq_chunk", 0)))
    if case.get("expert_split"):
        cfg = replace(cfg, act_shard_moe=ExpertSplit(mesh))
    local = shard_tree(lm_params_from_numpy(case["params"], device="cpu"),
                       specs["params"], mesh)
    rows = filter_spec(("data", None), tokens.shape, axis_sizes(mesh))
    toks = shard_leaf(tokens, rows, mesh)
    extra = {k: shard_leaf(torch.from_numpy(v), rows, mesh)
             for k, v in case.get("extra", {}).items()}
    kw = dict(device="cpu", mesh=mesh, specs=specs)
    seen = []
    with coll.counting(seen.append):
        logits, cache = lm.prefill(local, {"tokens": toks[:, :s], **extra},
                                   cfg, max_len=max_len, **kw)
        steps = [lm.gather_logits(logits, cfg, mesh=mesh, specs=specs)]
        for i in range(total - s):
            logits, cache = lm.decode_step(local, cache,
                                           toks[:, s + i:s + i + 1], s + i,
                                           cfg, **kw)
            steps.append(lm.gather_logits(logits, cfg, mesh=mesh,
                                          specs=specs))
        fwd = lm.forward(local, {"tokens": toks, **extra}, cfg, **kw)
    return {"coords": mesh.coords,
            "steps": torch.stack(steps, dim=1),
            "forward": lm.gather_logits(fwd, cfg, mesh=mesh,
                                        specs=specs)[..., :cfg.vocab_size],
            "local_vocab": fwd.shape[-1],
            "slots_held": _slots_held(cache),
            "collectives": sorted({(c.kind, c.axis) for c in seen}),
            "param_bytes": sum(x.numel() * x.element_size()
                               for x in _leaves(local))}


def _slots_held(cache) -> int | None:
    """The slots of the first attention cache leaf this rank holds that a
    prefill or decode step wrote (None without attention)."""
    for block in cache.values():
        if "k" in block:
            return int((block["k"].abs().sum(dim=(0, 1, 3, 4)) > 0).sum())
    return None


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def train_plan(mesh_or_axes, arch: str, *, S: int, b: int, knobs: dict,
               overrides: dict | None = None):
    """The reference's ``train_4k`` plan of the full ``arch`` on
    ``mesh_or_axes`` (with the plan ``overrides``), cut to ``S`` steps of
    ``b`` sequences and to the arch's reduced widths (the plan's regime,
    hooks and knobs kept, then ``knobs`` set on top)."""
    full = get_arch(arch)
    red = full.reduced()
    dims = {f.name: getattr(red, f.name) for f in fields(red)
            if getattr(red, f.name) != getattr(full, f.name)
            and f.name not in ("loss_chunk", "remat")}
    plan = make_plan(arch, "train_4k", mesh_or_axes, overrides=overrides)
    return replace(plan, S=S, b=b,
                   cfg=replace(plan.cfg, **{**dims, **knobs}))


def mamba_grads(mesh, cases: list) -> list | None:
    """Each case's loss on the (1, 2) sub-mesh of ``mesh`` (None on the
    ranks it leaves out): the reduced arch under its ``train_4k`` plan's
    lane specs (its Mamba mixers split over ``model`` by heads), this
    rank's shards of the numpy weights, the whole batch; the loss and its
    gradient with respect to this rank's shard of every leaf."""
    from repro_torch.distributed.sharding import tree_paths
    from repro_torch.launch.mesh import sub_mesh
    from repro_torch.launch.plan import sharding_specs
    sub = sub_mesh(mesh, (1, 2))
    if sub is None:
        return None
    out = []
    for case in cases:
        plan = train_plan(sub, case["arch"], S=1, b=case["tokens"].shape[0],
                          knobs=case["knobs"])
        lane = sharding_specs(plan, sub)["lane"]
        params = shard_tree(lm_params_from_numpy(case["params"],
                                                 device="cpu"),
                            lane["params"], sub)
        leaves = dict(tree_paths(params))
        for leaf in leaves.values():
            leaf.requires_grad_()
        loss = lm.loss_fn(params, {"tokens": torch.from_numpy(
            case["tokens"])}, plan.cfg, device="cpu", mesh=sub, specs=lane)
        loss.backward()
        out.append({"loss": loss.detach(),
                    "grads": {k: v.grad for k, v in leaves.items()},
                    "coords": sub.coords})
    return out


def train_rank(mesh, cases: list, probe: dict,
               grad_cases: list = ()) -> dict:
    """Each case's round on its mesh (the first ranks of ``mesh``,
    ``launch.mesh.sub_mesh``; None on a rank it leaves out): the reduced
    arch under its plan's regime, the rank's shards of the numpy weights,
    its block of the batches and masks, the case's gradient clip.  This rank's shards of the new global params, the
    metrics, the bytes of its parameter shards and K1's folds; the
    gradients of :func:`_gather_rule` on ``probe``; :func:`_sub_meshes`;
    :func:`mamba_grads` of ``grad_cases``; and when the rank entered this
    body.  The cross-worker reduce runs in
    column chunks of at most 2^16 gathered elements, so that a round takes
    several."""
    from repro_torch.fl import round as fl_round
    from repro_torch.kernels import ops
    from repro_torch.launch.plan import sharding_specs
    from repro_torch.launch.steps import make_train_step
    from repro_torch.kernels.layout import flatten_tree, unflatten_tree
    from repro_torch.launch.mesh import make_mesh, sub_mesh
    started = time.time()
    fl_round.MESH_REDUCE_ELEMS = 1 << 16
    out = []
    full = mesh
    for case in cases:
        if case["axes"] == full.axis_names:
            mesh = sub_mesh(full, case["mesh"])
        else:               # all the ranks, laid out over other axes
            mesh = make_mesh(case["mesh"], case["axes"],
                             backend=full.backend, device=full.device)
        if mesh is None:
            out.append(None)
            continue
        plan = train_plan(mesh, case["arch"], S=case["S"], b=case["b"],
                          knobs=case["knobs"],
                          overrides=case.get("overrides"))
        specs = sharding_specs(plan, mesh)
        params = shard_tree(lm_params_from_numpy(case["params"],
                                                 device="cpu"),
                            specs["params"], mesh)
        batches = shard_tree({k: torch.from_numpy(v) for k, v in
                              case["batches"].items()}, specs["batches"],
                             mesh)
        masks = [shard_leaf(torch.from_numpy(case[k]), specs["masks"], mesh)
                 for k in ("step_mask", "boundary", "weight")]
        step = make_train_step(plan, mesh=mesh, specs=specs,
                               grad_clip=case.get("grad_clip"))
        calls = []
        real = ops.fedavg_accum
        ops.fedavg_accum = lambda *a: (calls.append(tuple(a[1].shape)),
                                       real(*a))[1]
        try:
            new, metrics = step(flatten_tree(params), batches, *masks)
        finally:
            ops.fedavg_accum = real
        out.append({
            "params": {k: v.clone() for k, v in
                       flatten_tree(unflatten_tree(dict(new))).items()},
            "metrics": {k: getattr(metrics, k) for k in metrics._fields},
            "param_bytes": sum(x.numel() * x.element_size()
                               for x in _leaves(params)),
            "folds": calls, "regime": (plan.policy, plan.worker_axes,
                                       plan.batch_axes, plan.W, plan.P),
            "dispatch": plan.cfg.moe_dispatch is not None,
            "expert_split": plan.cfg.act_shard_moe is not None,
            "coords": mesh.coords})
    return {"coords": full.coords, "started": started, "cases": out,
            "gather_rule": _gather_rule(full, probe),
            "sub_meshes": _sub_meshes(full),
            "mamba_grads": mamba_grads(full, list(grad_cases))}


SUB_SHAPES = ((1, 2), (2, 1), (1, 1))


def _sub_meshes(mesh) -> dict:
    """Each of ``SUB_SHAPES`` made on ``mesh``'s ranks by ``sub_mesh``:
    ``None`` where this rank is left out, else its coords and, per axis, the
    sum of ``rank + 1`` over its group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import sub_mesh
    out = {}
    for shape in SUB_SHAPES:
        sub = sub_mesh(mesh, shape)
        if sub is None:
            out[shape] = None
            continue
        sums = {}
        for axis in sub.axis_names:
            t = torch.tensor(float(sub.rank + 1))
            dist.all_reduce(t, group=sub.groups[axis])
            sums[axis] = float(t)
        out[shape] = {"coords": sub.coords, "sums": sums}
    return out


def _gather_rule(mesh, probe: dict) -> dict:
    """The gradients of ``Σ_rows ((x W) ⊙ v)²`` on this rank: ``x [4, 8]``
    split over ``data``, ``W [8, 6]`` over ``("data", "model")``, ``v``
    replicated, each gathered by ``gather_leaf`` under the training rule
    (``batch_axes=("data",)``) and under the serve convention."""
    from repro_torch.distributed.sharding import gather_leaf
    x = shard_leaf(torch.from_numpy(probe["x"]), ("data",), mesh)
    specs = {"w": ("data", "model"), "v": ()}
    out = {}
    for rule, batch_axes in (("train", ("data",)), ("serve", None)):
        local = {k: shard_leaf(torch.from_numpy(probe[k]), specs[k],
                               mesh).requires_grad_() for k in specs}
        w, v = (gather_leaf(local[k], specs[k], mesh, batch_axes=batch_axes)
                for k in ("w", "v"))
        (((x @ w) * v) ** 2).sum().backward()
        out[rule] = {k: t.grad for k, t in local.items()}
    return out
