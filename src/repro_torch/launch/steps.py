"""The steps: the function each dry-run cell runs, bound to its inputs —
port of ``repro/launch/steps.py``.

* train   → Pollen's federated round (Fig. 5b): W workers × P lanes × S
            local steps, per-lane streaming partial aggregation (Eq. 1, K1),
            the weighted-mean reduce — :func:`~repro_torch.fl.round
            .make_round_step` bound to the arch's loss and the paper's
            client optimizer (SGD momentum, A.1);
* prefill → the full-prompt forward returning (last logits, filled cache);
* decode  → one-token serve step against a KV/SSM cache of ``seq_len``.

The reference jits these with the plan's shardings and lowers them on
``ShapeDtypeStruct`` stand-ins; :func:`build_step` binds them to tensors on
a device instead: meta tensors (nothing allocated, nothing computed) for
the cost counter, or random inputs on the card for a run.  Given a mesh of
several ranks it binds the step to this rank's shards under the plan's
specs: a serve step's parameters, batch and cache; a train step's
parameters, its workers' block of the batches and masks, and the round of
:func:`~repro_torch.fl.round.make_round_step` on a mesh.
"""

from __future__ import annotations

import math

import torch

# The engine (``repro_torch.core``) imports the round module, which imports
# ``core.aggregation``: loading ``core`` first resolves that cycle.
from repro_torch.core import EngineConfig  # noqa: F401
from repro_torch.fl.round import make_round_step
from repro_torch.kernels.layout import flatten_tree
from repro_torch.distributed.sharding import (local_shape, shard_leaf,
                                              shard_tree, tree_paths)
from repro_torch.launch.plan import (Plan, input_specs, meta_params,
                                     sharding_specs)
from repro_torch.models import lm, make_lane_loss_fn
from repro_torch.optim import sgd

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "build_step", "device_params", "CLIENT_LR", "CLIENT_MOMENTUM"]

# Paper A.1 client optimizer (IC/SR task family); LM archs reuse it — the FL
# round semantics, not the LM hyperparameters, are what the cell exercises.
CLIENT_LR = 0.05
CLIENT_MOMENTUM = 0.9


def make_train_step(plan: Plan, *, agg_impl: str = "kernel", mesh=None,
                    specs=None, grad_clip: float | None = None):
    """The round step; its folds go through K1 (the plain version on CPU
    tensors, the kernel's work on meta ones).  With ``mesh`` (and the
    plan's ``specs`` on it, :func:`~repro_torch.launch.plan
    .sharding_specs`) the round of one rank.  ``grad_clip``: the clients'
    gradient clip (``make_round_step``'s)."""
    if mesh is None or mesh.size == 1:
        mesh = specs = None
    return make_round_step(
        make_lane_loss_fn(plan.cfg, mesh=mesh, specs=specs and specs["lane"]),
        sgd(CLIENT_LR, momentum=CLIENT_MOMENTUM), agg_impl=agg_impl,
        grad_clip=grad_clip, mesh=mesh, worker_axes=plan.worker_axes,
        specs=specs and specs["params"])


def make_prefill_step(plan: Plan, device, *, mesh=None, specs=None):
    cfg = plan.cfg

    def prefill_step(params, batch):
        return lm.prefill(params, batch, cfg, device=device, mesh=mesh,
                          specs=specs)

    return prefill_step


def make_decode_step(plan: Plan, device, *, mesh=None, specs=None):
    """One token at the cache's last slot (``seq_len - 1``): the reference
    passes a traced position, the port's ``decode_step`` an int."""
    cfg = plan.cfg
    pos = plan.seq_len - 1

    def serve_step(params, cache, tokens):
        return lm.decode_step(params, cache, tokens, pos, cfg, device=device,
                              mesh=mesh, specs=specs)

    return serve_step


def device_params(cfg, seed: int, device, *, keep=None) -> dict:
    """Random weights of ``cfg`` drawn on ``device`` from ``seed``, in the
    dtypes :func:`~repro_torch.models.lm.init_params` gives: its fixed
    leaves (:func:`~repro_torch.models.lm.fixed_leaf`) as it makes them;
    every other leaf N(0, 1) clipped at ±2 times its scale (``1/√fan_in``;
    0.02 for embeddings and learned positions), the truncated normal of
    ``dense_init`` clipped instead of redrawn, so that billions of weights
    cost no host time.  The weights differ from ``init_params(seed)``'s.

    ``keep(path, leaf)``, where given, is applied to each leaf as soon as it
    is drawn (``path`` its keys joined with ``/``), and its result is kept:
    a rank of a mesh keeps its shard, so the whole model never exists at
    once, and draws every leaf as one process would."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def leaf(name, shape):
        dtype = lm.leaf_dtype(name, cfg)
        fixed = lm.fixed_leaf(name, shape, dtype)
        if fixed is not None:
            return fixed.to(dtype).to(device)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 0.02 if name in ("embed", "pos_embed") \
            else 1.0 / math.sqrt(fan_in)
        w = torch.randn(shape, generator=gen, device=device)
        return w.clamp_(-2.0, 2.0).mul_(scale).to(dtype)

    def build(shapes, prefix=""):
        out = {}
        for k, v in shapes.items():
            if isinstance(v, dict):
                out[k] = build(v, f"{prefix}{k}/")
            else:
                out[k] = leaf(k, tuple(v))
                if keep is not None:
                    out[k] = keep(f"{prefix}{k}", out[k])
        return out

    return build(lm.param_shapes(cfg))


def _fill(spec: torch.Tensor, cfg, gen) -> torch.Tensor:
    """Random values for one input of ``spec``'s shape and dtype: token ids
    below the vocab size, N(0, 1) stubs."""
    if spec.dtype == torch.int32:
        return torch.randint(0, cfg.vocab_size, spec.shape, generator=gen,
                             dtype=torch.int32, device=spec.device)
    return torch.randn(spec.shape, generator=gen,
                       device=spec.device).to(spec.dtype)


def build_step(plan: Plan, device="meta", *, params: dict | None = None,
               seed: int = 0, mesh=None):
    """``(fn, args)``: the plan's step and its inputs on ``device``.

    On meta (the default) the parameters are :func:`~repro_torch.launch
    .plan.meta_params` and every input an empty tensor of the reference's
    shape and dtype.  On another device ``params`` (the nested tree;
    default :func:`device_params`) and random inputs from ``seed``: a train
    cell's lanes each hold one client of S real steps (mask 1, the
    boundary and the weight ``b`` at the last step), a decode cell starts
    from a zeroed cache.

    With ``mesh`` (of more than one rank) the parameters and inputs are
    this rank's shards under :func:`~repro_torch.launch.plan
    .sharding_specs` (``params``, where given, must be shards already): a
    serve step's batch and cache, a train step's block of the batches and
    masks.  Inputs are drawn whole from ``seed`` and sliced, so every
    rank's slices make one batch, the batch of the one-card step."""
    device = torch.device(device)
    if mesh is not None and mesh.size > 1:
        return _build_mesh_step(plan, device, params, seed, mesh)
    meta = device.type == "meta"
    cfg = plan.cfg
    if params is None:
        params = meta_params(cfg) if meta else device_params(cfg, seed,
                                                             device)
    specs = input_specs(plan, device)
    gen = None if meta else torch.Generator(device=device).manual_seed(
        int(seed) + 1)
    if plan.kind == "train":
        batches = specs["batches"]
        step_mask, boundary, weight = (specs[k] for k in ("step_mask",
                                                          "boundary",
                                                          "weight"))
        if not meta:
            batches = {k: _fill(v, cfg, gen) for k, v in batches.items()}
            step_mask, boundary, weight = _train_masks(plan, device)
        return make_train_step(plan), (flatten_tree(params), batches,
                                       step_mask, boundary, weight)
    if plan.kind == "prefill":
        batch = specs["batch"]
        if not meta:
            batch = {k: _fill(v, cfg, gen) for k, v in batch.items()}
        return make_prefill_step(plan, device), (params, batch)
    tokens = specs["tokens"] if meta else _fill(specs["tokens"], cfg, gen)
    return make_decode_step(plan, device), (params, specs["cache"], tokens)


def _train_masks(plan: Plan, device):
    """``(step_mask, boundary, weight)`` of a run: every step real, one
    client a lane ending at its last step, weighted ``b``."""
    step_mask = torch.ones((plan.W, plan.P, plan.S), device=device)
    boundary = torch.zeros_like(step_mask)
    boundary[..., -1] = 1.0
    return step_mask, boundary, boundary * float(plan.b)


def _build_mesh_step(plan: Plan, device, params, seed: int, mesh):
    """:func:`build_step` on a mesh of several ranks."""
    meta = device.type == "meta"
    cfg = plan.cfg
    specs = sharding_specs(plan, mesh)
    if params is None:
        if meta:
            params = shard_tree(meta_params(cfg), specs["params"], mesh)
        else:
            pspec = dict(tree_paths(specs["params"]))
            params = device_params(cfg, seed, device, keep=lambda path, x:
                                   shard_leaf(x, pspec[path], mesh))
    whole = input_specs(plan, "meta")
    gen = None if meta else torch.Generator(device=device).manual_seed(
        int(seed) + 1)

    def draw(spec_t):
        t = torch.empty(spec_t.shape, dtype=spec_t.dtype, device=device)
        return t if meta else _fill(t, cfg, gen)

    if plan.kind == "train":
        batches = shard_tree({k: draw(v) for k, v in
                              whole["batches"].items()},
                             specs["batches"], mesh)
        masks = tuple(whole[k] for k in ("step_mask", "boundary", "weight")) \
            if meta else _train_masks(plan, device)
        masks = tuple(shard_leaf(m, specs["masks"], mesh) for m in masks)
        return (make_train_step(plan, mesh=mesh, specs=specs),
                (flatten_tree(params), batches) + masks)
    if plan.kind == "prefill":
        batch = shard_tree({k: draw(v) for k, v in whole["batch"].items()},
                           specs["batch"], mesh)
        return (make_prefill_step(plan, device, mesh=mesh, specs=specs),
                (params, batch))
    cache = {key: {name: torch.zeros(
        local_shape(leaf.shape, specs["cache"][key][name], mesh),
        dtype=leaf.dtype, device=device) for name, leaf in block.items()}
        for key, block in whole["cache"].items()}
    tokens = shard_leaf(draw(whole["tokens"]), specs["tokens"], mesh)
    return (make_decode_step(plan, device, mesh=mesh, specs=specs),
            (params, cache, tokens))
