"""Per-(arch × shape × mesh) execution planning — port of
``repro/launch/plan.py``.

``make_plan`` decides, for one dry-run or training cell, what the
reference decides from its mesh's axis sizes:

* the FL worker topology: which axes index Pollen workers (W), lanes per
  worker (P), local steps (S), per-step batch (b), with W·P·S·b equal to
  the cell's global batch;
* the sharding ``policy``: ``"tp"`` where one client copy fits a worker,
  ``"fsdp_tp"`` for the archs above :data:`LARGE_PARAM_BYTES`;
* the implementation knobs (attention, MoE dispatch, remat, loss chunk,
  SSD chunk, learned-position table) the reference sizes from napkin math;
* given a :class:`~repro_torch.launch.mesh.Mesh`, the MoE hooks exactly
  where the reference sets them: ``act_shard_moe`` for every MoE arch (an
  :class:`~repro_torch.distributed.sharding.ExpertSplit` over ``model``:
  a MoE layer that the dispatch does not take computes the rank's block
  of its expert buffers), and the expert-parallel ``moe_dispatch``
  (:func:`~repro_torch.distributed.ep_dispatch.make_ep_dispatch`) for
  large MoE archs whose expert count divides the model axis, outside a
  vmapped train cell (it takes precedence where both are set).

Given only axis sizes (a dict, or nothing: one card) the hooks stay unset,
so the one-card dry-run counts what it counted before.  The reference's
layout hooks ``act_shard``, ``act_gather`` and ``act_shard_logits`` are
``with_sharding_constraint``s that make XLA split a client's layers over
``model``; the port computes that split itself
(:mod:`repro_torch.models.lm`), and :func:`sharding_specs` hands it the
layouts as spec entries: ``"act"`` (the residual stream between blocks,
``(batch_axes, seq_axes, None)``) and ``"logits"`` (split over the
vocabulary on ``model``, where the reference installs
``act_shard_logits``: ``"model"`` is not a worker axis).  ``act_gather``
is the split blocks' entry.

:func:`sharding_specs` gives the filtered specs of the parameters and of
each input of the planned step on a mesh; ``input_specs`` gives meta
tensors of the reference's shapes and dtypes for every input;
``meta_params`` the parameters the same way, from
:func:`~repro_torch.models.lm.param_shapes` (no weights drawn).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from repro_torch.configs import SHAPES, ArchConfig, get_arch
from repro_torch.distributed.sharding import (ExpertSplit, filtered_specs,
                                              make_sharding_rules)
from repro_torch.launch.mesh import Mesh, axis_sizes
from repro_torch.models import lm

__all__ = ["make_plan", "input_specs", "Plan", "LARGE_PARAM_BYTES",
           "param_bytes", "param_leaves", "runnable", "skip_reason",
           "meta_params", "DEFAULT_AXES", "sharding_specs", "cache_specs",
           "param_bytes_per_card", "lane_specs", "ep_seq_chunk"]

LARGE_PARAM_BYTES = 16e9      # bf16 bytes; above this one client = one pod
# One card: a mesh of one device, as the reference's 1x1 test mesh.
DEFAULT_AXES = {"data": 1, "model": 1}


def param_leaves(cfg: ArchConfig):
    """``(path, shape, dtype)`` of every parameter of ``cfg`` in
    :func:`~repro_torch.models.lm.param_shapes`' tree order, the path's
    keys joined with ``/``, each dtype as ``init_params`` gives it."""
    def walk(shapes, prefix):
        for k, v in shapes.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", tuple(v), lm.leaf_dtype(k, cfg)

    return walk(lm.param_shapes(cfg), "")


def meta_params(cfg: ArchConfig, device="meta") -> dict:
    """The nested parameter tree of ``cfg`` as empty tensors on ``device``
    (meta by default): :func:`~repro_torch.models.lm.param_shapes`' shapes,
    each leaf in the dtype :func:`~repro_torch.models.lm.init_params` gives
    it."""
    def build(shapes):
        return {k: build(v) if isinstance(v, dict) else
                torch.empty(v, dtype=lm.leaf_dtype(k, cfg), device=device)
                for k, v in shapes.items()}

    return build(lm.param_shapes(cfg))


def param_bytes(cfg: ArchConfig) -> int:
    """Bytes of ``cfg``'s parameters, f32 leaves included (the reference
    counts them from ``jax.eval_shape(init_params)``)."""
    return sum(math.prod(shape) * torch.empty((), dtype=dtype).element_size()
               for _, shape, dtype in param_leaves(cfg))


def param_bytes_per_card(plan: "Plan", mesh) -> int:
    """Bytes of one card's parameter shards under the plan's specs on
    ``mesh`` (a Mesh or axis sizes): the reference's ``NamedSharding
    .shard_shape`` of every leaf, times its item size."""
    from repro_torch.distributed.sharding import local_shape, tree_paths
    specs = dict(tree_paths(sharding_specs(plan, mesh)["params"]))
    return sum(math.prod(local_shape(shape, specs[path], mesh))
               * torch.empty((), dtype=dtype).element_size()
               for path, shape, dtype in param_leaves(plan.cfg))


def skip_reason(cfg: ArchConfig, shape_name: str) -> str | None:
    """The assignment's declared skips."""
    if shape_name not in SHAPES:
        raise KeyError(f"unknown shape {shape_name!r}")
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("full quadratic attention at 524288 tokens — skipped per "
                "assignment; runs only for ssm/hybrid families")
    return None


def runnable(cfg: ArchConfig, shape_name: str) -> bool:
    return skip_reason(cfg, shape_name) is None


@dataclass(frozen=True)
class Plan:
    arch: str
    shape: str
    kind: str                  # 'train' | 'prefill' | 'decode'
    policy: str                # 'tp' | 'fsdp_tp'
    worker_axes: tuple         # axes indexing FL workers (train only)
    W: int
    P: int
    S: int
    b: int
    batch_axes: tuple          # per-step batch dim sharding
    seq_axes: tuple            # activation sequence sharding (SP)
    seq_len: int
    global_batch: int
    cfg: ArchConfig            # knobs (+ the MoE hooks on a mesh) injected
    large: bool

    @property
    def worker_spmd_axes(self):
        if not self.worker_axes:
            return None
        return self.worker_axes if len(self.worker_axes) > 1 \
            else self.worker_axes[0]


def ep_seq_chunk(cfg) -> int:
    """The sequence block the plan's expert-parallel dispatch routes at once
    (0: the whole sequence), as the reference sets it: wide experts
    (jamba's 14,336) need blocks.  A MoE layer without the dispatch routes
    blocks of ``cfg.moe_seq_chunk`` (512 in every plan) instead, so where
    tokens are dropped the two route different groups of tokens and are
    different functions (the reference's are too)."""
    return 2048 if cfg.moe_d_ff >= 4096 else 0


def make_plan(arch: str | ArchConfig, shape_name: str,
              axes: dict | Mesh | None = None,
              overrides: dict | None = None) -> Plan:
    """The plan of one cell on ``axes``: a :class:`Mesh` (the hooks are
    made for it), or axis sizes ``{name: size}`` in mesh order (default
    one card; no hooks).  ``overrides``: hillclimb knobs — plan fields
    (W/P/S/b/worker_axes/batch_axes/seq_axes/policy) and/or ArchConfig knob
    fields (attn_impl, moe_seq_chunk, loss_chunk, …) applied on top of the
    default plan, as in the reference."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name]
    reason = skip_reason(cfg, shape_name)
    if reason:
        raise ValueError(f"{cfg.name} × {shape_name} skipped: {reason}")
    mesh = axes if isinstance(axes, Mesh) else None
    ax = axis_sizes(DEFAULT_AXES if axes is None else axes)
    has_pod = "pod" in ax
    large = param_bytes(cfg) > LARGE_PARAM_BYTES
    gb, seq = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        if large:
            worker_axes = ("pod",) if has_pod else ()
            W = ax.get("pod", 1) if has_pod else 1
            # S=8 local steps cut the per-step microbatch to 32 (the
            # reference's HBM budget for the 52-104B archs).
            Pl, S = 1, 8
            batch_axes, seq_axes = ("data",), ("model",)
        else:
            # One FL worker per chip when the client state (θ + momentum +
            # partial + grads ≈ 4.5× params) fits a chip's 10 GiB.
            n_dev = math.prod(ax.values())
            per_chip = (4.5 * param_bytes(cfg) < 10 * 2 ** 30
                        and gb % n_dev == 0 and gb // n_dev <= 8)
            if per_chip:
                worker_axes = tuple(ax)          # every mesh axis
                W = n_dev
                Pl, S = 1, gb // n_dev
            else:
                worker_axes = ("pod", "data") if has_pod else ("data",)
                W = math.prod(ax[a] for a in worker_axes)
                Pl, S = 1, 4
            batch_axes, seq_axes = (), ()
        b = gb // (W * Pl * S)
        while b == 0 and Pl > 1:
            Pl //= 2
            b = gb // (W * Pl * S)
        while b == 0 and S > 1:
            S //= 2
            b = gb // (W * Pl * S)
        if W * Pl * S * b != gb:
            raise ValueError(f"{cfg.name}×{shape_name}: cannot factor "
                             f"global_batch {gb} as W{W}·P{Pl}·S{S}·b{b}")
    else:
        worker_axes, W, Pl, S = (), 1, 1, 1
        b = gb
        batch_axes = tuple(a for a in ("pod", "data") if a in ax and gb > 1)
        seq_axes = ("model",) if large else ()

    # ---- knobs sized by the reference's napkin math -----------------------
    knobs: dict = {}
    if cfg.n_heads:
        if shape.kind == "train" or shape.kind == "prefill":
            tp = 1 if "model" in worker_axes else ax.get("model", 1)
            if shape.kind == "train" and not large \
                    and cfg.n_heads % tp == 0:
                knobs["attn_impl"] = "dense"
            else:
                knobs["attn_impl"] = "chunked"
                knobs["attn_q_chunk"] = 512
            knobs["attn_repeat_kv"] = large   # even TP head sharding
    if cfg.moe:
        knobs["moe_impl"] = "scatter"
        knobs["moe_seq_chunk"] = 512
    if shape.kind == "train":
        knobs["remat"] = True
        if "model" in worker_axes:
            knobs["loss_chunk"] = 1024
        else:
            knobs["loss_chunk"] = 512 if cfg.vocab_size >= 100_000 else 1024
        if cfg.ssm_state and large:
            knobs["ssd_chunk"] = 64
    if cfg.learned_pos:
        knobs["max_position"] = max(cfg.max_position, seq)
    # ---- hillclimb overrides ----------------------------------------------
    plan_fields = {}
    for k, v in (overrides or {}).items():
        if k in ("worker_axes", "batch_axes", "seq_axes"):
            plan_fields[k] = tuple(v) if v else ()
        elif k in ("W", "P", "S", "b", "policy"):
            plan_fields[k] = v
        else:
            knobs[k] = v
    if plan_fields:
        worker_axes = plan_fields.get("worker_axes", worker_axes)
        batch_axes = plan_fields.get("batch_axes", batch_axes)
        seq_axes = plan_fields.get("seq_axes", seq_axes)
        W = plan_fields.get("W", math.prod(ax[a] for a in worker_axes)
                            if worker_axes else 1)
        Pl = plan_fields.get("P", Pl if shape.kind == "train" else 1)
        S = plan_fields.get("S", S if shape.kind == "train" else 1)
        b = plan_fields.get("b", gb // max(W * Pl * S, 1))
        if shape.kind == "train" and W * Pl * S * b != gb:
            raise ValueError(f"override does not factor {gb}: "
                             f"{W}·{Pl}·{S}·{b}")
    hooks = {}
    if mesh is not None and cfg.moe:
        hooks["act_shard_moe"] = ExpertSplit(mesh, "model")
    n_model = ax.get("model", 1)
    vmapped_train = shape.kind == "train" and not (W == 1 and Pl == 1)
    if mesh is not None and cfg.moe and large \
            and cfg.n_experts % n_model == 0 and not vmapped_train:
        from repro_torch.distributed.ep_dispatch import make_ep_dispatch
        hooks["moe_dispatch"] = make_ep_dispatch(
            mesh, batch_axes=batch_axes or (), model_axis="model",
            fsdp_axis=("data" if "data" not in worker_axes else None),
            seq_chunk=ep_seq_chunk(cfg))
    cfg2 = replace(cfg, **knobs, **hooks)
    policy = (overrides or {}).get("policy",
                                   "fsdp_tp" if large else "tp")
    return Plan(arch=cfg.name, shape=shape_name, kind=shape.kind,
                policy=policy,
                worker_axes=worker_axes, W=W, P=Pl, S=S, b=b,
                batch_axes=batch_axes, seq_axes=seq_axes, seq_len=seq,
                global_batch=gb, cfg=cfg2, large=large)


def _spec(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def input_specs(plan: Plan, device="meta") -> dict:
    """Empty tensors on ``device`` (meta by default) with the reference's
    shapes and dtypes, for every input of the planned step."""
    cfg = plan.cfg
    bf16, i32, f32 = torch.bfloat16, torch.int32, torch.float32
    if plan.kind == "train":
        lead = (plan.W, plan.P, plan.S, plan.b)
        seq_text = plan.seq_len
        batches = {}
        if cfg.frontend == "patch":
            seq_text = plan.seq_len - cfg.frontend_len
            batches["patch_embed"] = _spec(
                lead + (cfg.frontend_len, cfg.resolved_frontend_dim), bf16,
                device)
        if cfg.frontend == "audio":
            batches["frames"] = _spec(
                lead + (cfg.frontend_len, cfg.d_model), bf16, device)
        batches["tokens"] = _spec(lead + (seq_text,), i32, device)
        m = (plan.W, plan.P, plan.S)
        return {"batches": batches, "step_mask": _spec(m, f32, device),
                "boundary": _spec(m, f32, device),
                "weight": _spec(m, f32, device)}
    if plan.kind == "prefill":
        seq_text = plan.seq_len
        batch = {}
        if cfg.frontend == "patch":
            seq_text = plan.seq_len - cfg.frontend_len
            batch["patch_embed"] = _spec(
                (plan.b, cfg.frontend_len, cfg.resolved_frontend_dim), bf16,
                device)
        if cfg.frontend == "audio":
            batch["frames"] = _spec((plan.b, cfg.frontend_len, cfg.d_model),
                                    bf16, device)
        batch["tokens"] = _spec((plan.b, seq_text), i32, device)
        return {"batch": batch}
    # decode: one new token against a cache of seq_len
    return {
        "cache": lm.init_cache(cfg, plan.b, plan.seq_len, device=device),
        "tokens": _spec((plan.b, 1), i32, device),
        "pos": _spec((), i32, device),
    }


def cache_specs(cfg: ArchConfig, rules: dict, batch: int, max_len: int,
                mesh) -> dict:
    """The filtered kv specs of the serve cache of ``batch`` sequences of
    ``max_len`` (the reference's ``kv`` rules on ``init_cache``'s tree)."""
    cache = lm.init_cache(cfg, batch, max_len, device="meta")
    return filtered_specs(rules["kv"].tree_specs(cache), cache, mesh)


def lane_specs(specs: dict, worker_axes, seq_axes=()) -> dict:
    """What a lane of a training rank computes on: ``{"params": specs,
    "batch_axes": axes, "act": ..., ["logits": ...]}``, each parameter's
    spec without the worker axes (a lane's client is replicated over them),
    the axes the rank's batch is split over, as the filtered spec of
    ``specs["batches"]`` gives them (an axis that does not divide ``b``
    splits nothing), the residual stream's layout ``(batch, seq, None)``
    and, where ``model`` is no worker axis, the logits' ``(batch, None,
    "model")``: the layers are split over ``model``."""
    from repro_torch.distributed.sharding import split_axes

    def strip(tree):
        return {k: strip(v) if isinstance(v, dict) else
                split_axes(v, tuple(worker_axes))[0]
                for k, v in tree.items()}

    entry = specs["batches"]["tokens"][3]
    batch_axes = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    out = {"params": strip(specs["params"]), "batch_axes": batch_axes,
           "act": (entry, _entry(seq_axes), None)}
    if "model" not in worker_axes:
        out["logits"] = (entry, None, "model")
    return out


def _entry(axes):
    """A spec entry naming ``axes``: None, one name or a tuple."""
    axes = tuple(axes or ())
    return None if not axes else axes[0] if len(axes) == 1 else axes


def sharding_specs(plan: Plan, mesh) -> dict:
    """The filtered specs of the parameters (``params``) and of each input
    group of the planned step on ``mesh`` (a Mesh or axis sizes) — the
    reference's ``sharding_specs``, as spec tuples where it gives
    ``NamedSharding``s: ``rules``, ``params_shapes``; a train cell's
    ``batches`` and ``masks`` (and its ``lane``: :func:`lane_specs`); a
    prefill's ``batch``, a decode's ``tokens``, and both their ``cache``,
    ``logits`` (``[b, padded_vocab]``, the vocabulary over ``model``) and
    ``act`` (the residual stream ``[b, s, d_model]``: the batch over the
    batch axes, the sequence over the plan's ``seq_axes``; the model
    filters it on the stream's shape, so a decode's one position splits
    nothing)."""
    from repro_torch.distributed.sharding import filter_spec
    rules = make_sharding_rules(plan.policy, mesh, fl_axes=plan.worker_axes)
    shapes = lm.param_shapes(plan.cfg)
    out = {"params": filtered_specs(rules["params"].tree_specs(shapes),
                                    shapes, mesh),
           "rules": rules, "params_shapes": shapes}
    ax = axis_sizes(mesh)
    fl = plan.worker_axes or None
    ba = plan.batch_axes or None
    specs = input_specs(plan)

    def lead(x, spec):
        spec = tuple(spec) + (None,) * (x.ndim - len(spec))
        return filter_spec(spec, tuple(x.shape), ax)

    if plan.kind == "train":
        out["batches"] = {k: lead(v, (fl, None, None, ba))
                          for k, v in specs["batches"].items()}
        out["masks"] = (fl, None, None)
        out["lane"] = lane_specs(out, plan.worker_axes, plan.seq_axes)
        return out
    out["cache"] = cache_specs(plan.cfg, rules, plan.b, plan.seq_len, mesh)
    if plan.kind == "prefill":
        out["batch"] = {k: lead(v, (ba,)) for k, v in specs["batch"].items()}
    else:
        out["tokens"] = filter_spec((ba, None), (plan.b, 1), ax)
    out["act"] = (filter_spec((ba,), (plan.b,), ax)[0],
                  _entry(plan.seq_axes), None)
    out["logits"] = filter_spec((ba, "model"),
                                (plan.b, plan.cfg.padded_vocab), ax)
    return out
