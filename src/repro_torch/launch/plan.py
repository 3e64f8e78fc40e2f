"""Per-(arch × shape) execution planning — port of ``repro/launch/plan.py``.

``make_plan`` decides, for one dry-run or training cell, what the
reference decides from its mesh's axis sizes (``axis_sizes(mesh)``, the
only thing its logic reads), here given as a dict:

* the FL worker topology: which axes index Pollen workers (W), lanes per
  worker (P), local steps (S), per-step batch (b), with W·P·S·b equal to
  the cell's global batch;
* the sharding ``policy`` label: ``"tp"`` where one client copy fits a
  worker, ``"fsdp_tp"`` for the archs above :data:`LARGE_PARAM_BYTES`;
* the implementation knobs (attention, MoE dispatch, remat, loss chunk,
  SSD chunk, learned-position table) the reference sizes from napkin math.

The reference also injects sharding hooks (``act_shard``, ``act_gather``,
``act_shard_logits``, ``act_shard_moe``, ``moe_dispatch``): they split one
client's activations and weights over a TP/FSDP/EP mesh of several chips.
The port places whole clients on one card, so the plan keeps the
``policy`` label and leaves every hook unset (``docs/PORT.md``, the
``ShardingRules`` decision).

``input_specs`` gives meta tensors of the reference's shapes and dtypes for
every input of the planned step; ``meta_params`` the parameters the same
way, from :func:`~repro_torch.models.lm.param_shapes` (no weights drawn).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from repro_torch.configs import SHAPES, ArchConfig, get_arch
from repro_torch.models import lm

__all__ = ["make_plan", "input_specs", "Plan", "LARGE_PARAM_BYTES",
           "param_bytes", "param_leaves", "runnable", "skip_reason",
           "meta_params", "DEFAULT_AXES"]

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
    cfg: ArchConfig            # knobs injected; sharding hooks unset
    large: bool

    @property
    def worker_spmd_axes(self):
        if not self.worker_axes:
            return None
        return self.worker_axes if len(self.worker_axes) > 1 \
            else self.worker_axes[0]


def make_plan(arch: str | ArchConfig, shape_name: str,
              axes: dict | None = None,
              overrides: dict | None = None) -> Plan:
    """The plan of one cell on a mesh of ``axes`` (axis name -> size, in
    mesh order; default one card).  ``overrides``: hillclimb knobs — plan
    fields (W/P/S/b/worker_axes/batch_axes/seq_axes/policy) and/or
    ArchConfig knob fields (attn_impl, moe_seq_chunk, loss_chunk, …)
    applied on top of the default plan, as in the reference."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name]
    reason = skip_reason(cfg, shape_name)
    if reason:
        raise ValueError(f"{cfg.name} × {shape_name} skipped: {reason}")
    ax = dict(DEFAULT_AXES if axes is None else axes)
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
    cfg2 = replace(cfg, **knobs)
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
