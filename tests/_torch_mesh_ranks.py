"""Rank bodies for the port's mesh tests: spawned by
``repro_torch.launch.mesh.run_on_mesh`` on gloo ranks on the CPU.

A module of its own, importing neither JAX nor pytest, so that a spawned
rank loads only the port.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.configs import get_arch
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.ep_dispatch import make_ep_dispatch
from repro_torch.distributed.sharding import (filter_spec, filtered_specs,
                                              make_sharding_rules, shard_leaf,
                                              shard_tree)
from repro_torch.launch.mesh import axis_sizes
from repro_torch.launch.plan import cache_specs
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


def serve_rank(mesh, cases: list) -> dict:
    """Each case's reduced arch split over ``mesh`` under ``fsdp_tp``, its
    MoE layers through ``make_ep_dispatch``: this rank's prefill logits,
    its decode-step logits, its ``forward`` logits and the bytes of its
    parameter shards."""
    out = []
    for case in cases:
        cfg = replace(get_arch(case["arch"]).reduced(), **case["cfg"])
        tokens = torch.from_numpy(case["tokens"])
        s, max_len = case["prompt"], tokens.shape[1]
        rules = make_sharding_rules("fsdp_tp", mesh, fl_axes=())
        shapes = lm.param_shapes(cfg)
        specs = {"params": filtered_specs(
                     rules["params"].tree_specs(shapes), shapes, mesh),
                 "cache": cache_specs(cfg, rules, tokens.shape[0], max_len,
                                      mesh)}
        cfg = replace(cfg, moe_dispatch=make_ep_dispatch(
            mesh, batch_axes=("data",), fsdp_axis="data",
            seq_chunk=case.get("seq_chunk", 0)))
        local = shard_tree(lm_params_from_numpy(case["params"], device="cpu"),
                           specs["params"], mesh)
        toks = shard_leaf(tokens, filter_spec(("data", None), tokens.shape,
                                              axis_sizes(mesh)), mesh)
        kw = dict(device="cpu", mesh=mesh, specs=specs)
        logits, cache = lm.prefill(local, {"tokens": toks[:, :s]}, cfg,
                                   max_len=max_len, **kw)
        steps = [logits]
        for i in range(max_len - s):
            logits, cache = lm.decode_step(local, cache,
                                           toks[:, s + i:s + i + 1], s + i,
                                           cfg, **kw)
            steps.append(logits)
        out.append({
            "steps": torch.stack(steps, dim=1),
            "forward": lm.forward(local, {"tokens": toks}, cfg, **kw),
            "param_bytes": sum(x.numel() * x.element_size()
                               for x in _leaves(local))})
    return {"coords": mesh.coords, "cases": out}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
