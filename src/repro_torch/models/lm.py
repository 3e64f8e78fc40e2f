"""The LM stack — port of the dense, SSM, MoE and hybrid families of
``repro/models/lm.py``.

Every architecture is: embedding → a *period-structured* stack of blocks →
final norm → LM head.  A *period* is the smallest repeating pattern of layer
kinds (dense archs: 1).  Parameters keep the reference's layout — stacked
per period position with a leading ``n_periods`` dim,
``{"embed", "stack": {"p<i>": {name: [n_periods, ...]}}, "final_norm",
["lm_head"], ["patch_proj"], ["enc": {"stack", "final_norm", "pos_embed"}],
["pos_embed"]}`` — so weights carry across one to one
(:func:`repro_torch.models.lm_params_from_numpy`); the stack runs as a
Python loop over periods where the reference scans.

Ported block kinds: mixer ``attn`` (GQA + RoPE [+ qk-norm]) or ``mamba``
(the Mamba-2 SSD mixer of :mod:`repro_torch.models.ssd`), decoder
cross-attention against an encoder stack (whisper), MLP ``swiglu`` |
``relu2`` | ``gelu`` | ``moe`` (top-k routed experts,
:func:`repro_torch.models.layers.moe_layer_3d`) | none, and command-r's
``parallel_block``; the modality stubs: precomputed audio frames fed to
the encoder (``batch["frames"]``), patch embeddings projected in front of
the text (``batch["patch_embed"]``), and learned decoder positions.  A
config that sets ``moe_dispatch`` (the expert-parallel hook of
:func:`repro_torch.distributed.ep_dispatch.make_ep_dispatch`) routes its
MoE layers through it.

Entry points (``cuda`` unless ``device="cpu"`` is passed; without a card and
without that request they raise):

    init_params(seed, cfg)                        -> params
    forward(params, batch, cfg)                   -> logits [b, s, V] f32
                                                     (s counts the patches)
    loss_fn(params, batch, cfg)                   -> next-token CE, scalar
    init_cache(cfg, batch, max_len)               -> cache
    prefill(params, batch, cfg, max_len=)         -> (logits [b, Vp], cache)
    decode_step(params, cache, tokens, pos, cfg)  -> (logits [b, Vp], cache)

``loss_fn`` is differentiable (the federated round trains through it) and
adds ``cfg.moe_aux_weight`` times the MoE layers' load-balance term; the
serve entry points run under ``torch.no_grad``.  ``decode_step`` routes
its few tokens droplessly (``capacity_factor = n_experts / top_k``), as the
reference does.

``params`` must already be on the entry point's device; batches are moved
there.  Unlike the reference, ``prefill`` writes k/v (attention), the
cross-attention k/v of the encoder output, and the conv tail and SSM state
(Mamba) straight into the cache it allocates (the encoder runs once, where
the reference runs it a second time for the cross k/v), and
``decode_step`` updates ``cache`` in place (and returns it): the cache
is the largest buffer of the serve path and is never copied.

**On a mesh.**  ``forward``, ``prefill``, ``decode_step`` and ``loss_fn``
take ``mesh=`` (a :class:`~repro_torch.launch.mesh.Mesh` of more than one
rank) and ``specs={"params": ..., "cache": ...}`` (the filtered specs of
:func:`repro_torch.launch.plan.sharding_specs`; a training step's lane
specs also name its ``"batch_axes"``).  Each rank then holds its shard of
every parameter, its shard of the batch (split over the batch axes) and
its shard of the cache, and computes each layer whole: the layer's weights
and cache are all-gathered over the axes their specs name, one layer at a
time, and dropped after use; the embedding, head and norms are gathered
once a call.  Under ``cfg.remat`` a period's gathers run inside its
checkpoint, so the backward gathers it again.  The gathers' backward
follows :func:`~repro_torch.distributed.sharding.gather_leaf`'s training
rule.  MoE layers go through ``cfg.moe_dispatch``, which takes the rank's
own experts; without it a training rank gathers the batch's tokens for
the routing.  The logits are the rank's batch's.  A mesh of one rank is
the path without a mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shardlib
from repro_torch.models import ssd as ssdlib
from repro_torch.models.layers import (decode_attention, dense_init,
                                       gelu_mlp, gqa_attention, moe_layer_3d,
                                       norm_init, rms_norm, rope, swiglu)

__all__ = ["init_params", "param_shapes", "leaf_dtype", "forward", "loss_fn",
           "init_cache", "prefill", "decode_step", "layer_plan", "LayerKind",
           "param_count", "require_ported"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LayerKind:
    mixer: str          # 'attn' | 'mamba' | 'none'
    mlp: str            # 'swiglu' | 'relu2' | 'gelu' | 'moe' | 'none'
    cross: bool = False  # decoder cross-attention (whisper)


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def layer_plan(cfg: ArchConfig, *, decoder: bool = True) -> list[LayerKind]:
    """The repeating period of layer kinds for this architecture."""
    period = 1
    if cfg.attn_every > 1:
        period = _lcm(period, cfg.attn_every)
    if cfg.moe and cfg.moe_every > 1:
        period = _lcm(period, cfg.moe_every)
    n_layers = cfg.n_layers
    if n_layers % period:
        raise ValueError(f"{cfg.name}: n_layers {n_layers} not divisible by "
                         f"period {period}")
    plan = []
    for l in range(period):
        if cfg.family == "ssm":
            mixer = "mamba"
        elif cfg.attn_every > 1:
            mixer = "attn" if l % cfg.attn_every == cfg.attn_offset else "mamba"
        else:
            mixer = "attn"
        if cfg.moe and l % cfg.moe_every == cfg.moe_offset:
            mlp = "moe"
        elif cfg.d_ff > 0:
            mlp = cfg.mlp_act
        else:
            mlp = "none"
        cross = decoder and cfg.enc_layers > 0 and mixer == "attn"
        plan.append(LayerKind(mixer=mixer, mlp=mlp, cross=cross))
    return plan


def require_ported(cfg: ArchConfig) -> list[LayerKind]:
    """The layer plan, or ``NotImplementedError`` where ``cfg`` sets the
    ``act_shard_moe`` layout hook, which the port does not apply (ROADMAP,
    the ``act_*`` layouts)."""
    if cfg.act_shard_moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: act_shard_moe, an XLA layout constraint on the "
            f"expert buffers, is not ported; split experts over a mesh with "
            f"moe_dispatch (ROADMAP, the act_* layouts)")
    return layer_plan(cfg)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------
def _attn_shapes(cfg: ArchConfig) -> dict:
    hd = cfg.resolved_head_dim
    D = cfg.d_model
    sh = {
        "attn_norm": (D,),
        "wq": (D, cfg.n_heads * hd),
        "wk": (D, cfg.n_kv_heads * hd),
        "wv": (D, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, D),
    }
    if cfg.qk_norm:
        sh["q_norm"] = (hd,)
        sh["k_norm"] = (hd,)
    if cfg.use_bias:
        sh.update({"bq": (cfg.n_heads * hd,), "bk": (cfg.n_kv_heads * hd,),
                   "bv": (cfg.n_kv_heads * hd,), "bo": (D,)})
    return sh


def _cross_shapes(cfg: ArchConfig) -> dict:
    hd = cfg.resolved_head_dim
    D = cfg.d_model
    sh = {
        "xattn_norm": (D,),
        "xwq": (D, cfg.n_heads * hd),
        "xwk": (D, cfg.n_kv_heads * hd),
        "xwv": (D, cfg.n_kv_heads * hd),
        "xwo": (cfg.n_heads * hd, D),
    }
    if cfg.use_bias:
        sh.update({"xbq": (cfg.n_heads * hd,), "xbk": (cfg.n_kv_heads * hd,),
                   "xbv": (cfg.n_kv_heads * hd,), "xbo": (D,)})
    return sh


def _mlp_shapes(cfg: ArchConfig, kind: str) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    if kind == "swiglu":
        return {"mlp_norm": (D,), "w_gate": (D, F), "w_up": (D, F),
                "w_down": (F, D)}
    if kind in ("relu2", "gelu"):
        sh = {"mlp_norm": (D,), "w_up": (D, F), "w_down": (F, D)}
        if cfg.use_bias:
            sh.update({"b_up": (F,), "b_down": (D,)})
        return sh
    if kind == "moe":
        E, Fm = cfg.n_experts, cfg.moe_d_ff
        return {"mlp_norm": (D,), "router": (D, E),
                "moe_gate": (E, D, Fm), "moe_up": (E, D, Fm),
                "moe_down": (E, Fm, D)}
    return {}


def _mamba_shapes(cfg: ArchConfig) -> dict:
    return ssdlib.mamba_param_shapes(
        cfg.d_model, d_inner=cfg.d_inner, head_dim=cfg.ssm_head_dim,
        n_groups=cfg.ssm_groups, d_state=cfg.ssm_state, conv_k=cfg.ssm_conv)


def _block_shapes(cfg: ArchConfig, kind: LayerKind) -> dict:
    sh = {}
    if kind.mixer == "attn":
        sh.update(_attn_shapes(cfg))
    elif kind.mixer == "mamba":
        sh.update(_mamba_shapes(cfg))
    if kind.cross:
        sh.update(_cross_shapes(cfg))
    sh.update(_mlp_shapes(cfg, kind.mlp))
    if cfg.parallel_block and "mlp_norm" in sh:
        del sh["mlp_norm"]          # shared input norm (command-r style)
    return sh


_F32_ROWS = ("mamba_A", "mamba_dt_bias", "mamba_D")


def leaf_dtype(name: str, cfg: ArchConfig) -> torch.dtype:
    """The dtype :func:`init_params` gives the leaf whose last key is
    ``name``: f32 for norm scales and the Mamba per-head rows, ``cfg.dtype``
    for every other leaf (as the reference's ``init_params``)."""
    if "norm" in name or name in _F32_ROWS:
        return torch.float32
    return _DTYPES[cfg.dtype]


def fixed_leaf(name: str, shape, dtype):
    """The reference's init of a leaf that draws nothing, or None: norm
    scales 1 and biases 0; the Mamba rows ``A_log = log(linspace(1, 16,
    h))``, ``dt_bias = softplus^-1`` of dt log-spaced in ``[1e-3, 1e-1]``
    and ``D = 1``, all three in f32 whatever ``dtype`` is."""
    if "norm" in name:
        return norm_init(shape)
    if name.startswith(("b", "xb")) and len(shape) == 1:
        return torch.zeros(shape, dtype=dtype)
    f32 = torch.float32
    if name == "mamba_A":
        row = torch.log(torch.linspace(1.0, 16.0, shape[-1], dtype=f32))
        return row.expand(shape).contiguous()
    if name == "mamba_dt_bias":
        lo, hi = torch.log(torch.tensor([1e-3, 1e-1], dtype=f32))
        dt = torch.exp(torch.linspace(float(lo), float(hi), shape[-1],
                                      dtype=f32))
        return torch.log(torch.expm1(dt)).expand(shape).contiguous()
    if name == "mamba_D":
        return torch.ones(shape, dtype=f32)
    return None


def _init_leaf(gen: torch.Generator, name: str, shape, dtype):
    """The reference's init of one (stacked) leaf: :func:`fixed_leaf`, or
    drawn by :func:`dense_init`."""
    fixed = fixed_leaf(name, shape, dtype)
    return dense_init(gen, shape, dtype) if fixed is None else fixed


def _stack_shapes(cfg: ArchConfig, plan) -> dict:
    n_periods = cfg.n_layers // len(plan)
    return {f"p{i}": {name: (n_periods,) + tuple(shape)
                      for name, shape in sorted(
                          _block_shapes(cfg, kind).items())}
            for i, kind in enumerate(plan)}


def param_shapes(cfg: ArchConfig) -> dict:
    """The shape of every parameter of ``cfg``, in :func:`init_params`'s
    tree and draw order (no weights drawn): the reference's tree, with
    ``patch_proj`` for a patch frontend, ``enc`` (the encoder's stack,
    final norm and learned positions ``[frontend_len, d_model]``) for an
    encoder, and ``pos_embed [max_position, d_model]`` for learned
    decoder positions."""
    shapes = {
        "embed": (cfg.padded_vocab, cfg.d_model),
        "stack": _stack_shapes(cfg, require_ported(cfg)),
        "final_norm": (cfg.d_model,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.padded_vocab)
    if cfg.frontend == "patch":
        shapes["patch_proj"] = (cfg.frontend_dim, cfg.d_model)
    if cfg.enc_layers > 0:
        enc_cfg = cfg.encoder_cfg()
        shapes["enc"] = {
            "stack": _stack_shapes(enc_cfg,
                                   layer_plan(enc_cfg, decoder=False)),
            "final_norm": (cfg.d_model,),
            "pos_embed": (cfg.frontend_len, cfg.d_model)}
    if cfg.learned_pos:
        shapes["pos_embed"] = (cfg.max_position, cfg.d_model)
    return shapes


def init_params(seed: int, cfg: ArchConfig, *, device=None) -> dict:
    """Random weights for ``cfg`` from a ``torch.Generator`` seeded with
    ``seed``, drawn on the CPU (so a seed gives the same weights on every
    machine) and moved to ``device``.  They differ from the reference's
    ``jax.random`` init by design; the parity tests carry the reference's
    weights across instead.  Shapes, dtypes and layout are the
    reference's: matrices in ``cfg.dtype``; norm scales and the Mamba
    per-head rows in f32; the learned positions (encoder and decoder)
    drawn at scale 0.02, as the embedding."""
    shapes = param_shapes(cfg)
    device = resolve_device(device)
    dtype = _DTYPES[cfg.dtype]
    gen = torch.Generator().manual_seed(int(seed))

    def stack(leaves):
        return {key: {name: _init_leaf(gen, name, shape, dtype)
                      for name, shape in pos.items()}
                for key, pos in leaves.items()}

    params = {
        "embed": dense_init(gen, shapes["embed"], dtype, scale=0.02),
        "stack": stack(shapes["stack"]),
        "final_norm": norm_init(shapes["final_norm"]),
    }
    if "lm_head" in shapes:
        params["lm_head"] = dense_init(gen, shapes["lm_head"], dtype)
    if "patch_proj" in shapes:
        params["patch_proj"] = dense_init(gen, shapes["patch_proj"], dtype)
    if "enc" in shapes:
        enc = shapes["enc"]
        params["enc"] = {
            "stack": stack(enc["stack"]),
            "final_norm": norm_init(enc["final_norm"]),
            "pos_embed": dense_init(gen, enc["pos_embed"], dtype,
                                    scale=0.02)}
    if "pos_embed" in shapes:
        params["pos_embed"] = dense_init(gen, shapes["pos_embed"], dtype,
                                         scale=0.02)
    return _tree_map(lambda x: x.to(device), params)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_count(params) -> int:
    return sum(int(x.numel()) for x in _leaves(params))


def _on_device(params, device) -> torch.device:
    """``device`` resolved; raises unless every parameter lies there."""
    device = resolve_device(device)
    for leaf in _leaves(params):
        if leaf.device.type != device.type:
            raise ValueError(f"params are on {leaf.device}, the entry point "
                             f"runs on {device}; pass device= or move them")
    return device


# ---------------------------------------------------------------------------
# one rank's view of a client split over a mesh
# ---------------------------------------------------------------------------
_MOE_LEAVES = ("moe_gate", "moe_up", "moe_down")


@dataclass(frozen=True)
class _Shard:
    """What a rank of a mesh needs to compute each layer whole: the mesh,
    the parameter specs of the subtree at hand, the cache specs, the
    expert-parallel hook (its expert leaves stay local), and in a training
    step the axes its batch is split over (``None`` when serving: see
    :func:`~repro_torch.distributed.sharding.gather_leaf`)."""

    mesh: object
    specs: dict
    cache: dict | None
    dispatch: object = None
    batch_axes: tuple | None = None

    def at(self, *keys) -> "_Shard":
        specs = self.specs
        for k in keys:
            specs = specs[k]
        return replace(self, specs=specs)

    def gather(self, x, spec, *, batch_axes=None):
        return shardlib.gather_leaf(
            x, spec, self.mesh,
            batch_axes=self.batch_axes if batch_axes is None else batch_axes)

    def tops(self, params, specs=None) -> dict:
        """``params`` with every leaf outside a ``stack`` gathered whole."""
        specs = self.specs if specs is None else specs
        return {k: v if k == "stack" else
                self.tops(v, specs[k]) if isinstance(v, dict) else
                self.gather(v, specs[k])
                for k, v in params.items()}

    def period(self, stack, key: str, n: int) -> dict:
        """Period ``n``'s leaves of position ``key``, gathered whole; with
        the hook, its experts as the hook takes them.  ``stack[key]`` maps
        names to stacked leaves or to their unbound periods."""
        out = {}
        for name, leaf in stack[key].items():
            spec = self.specs[key][name][1:]
            if self.dispatch is not None and name in _MOE_LEAVES:
                out[name] = self._experts(leaf[n], spec, name)
            elif self.dispatch is not None and name == "router" \
                    and self.batch_axes is not None:
                # The hook sums the router's cotangent over every axis.
                out[name] = self.gather(leaf[n], spec, batch_axes=())
            else:
                out[name] = self.gather(leaf[n], spec)
        return out

    def _experts(self, x, spec, name: str):
        """This rank's expert shard as ``moe_dispatch`` splits it: experts
        over its model axis, ``D`` over its FSDP axis; resharded where the
        policy split them otherwise (serving only: the hook's gradient of
        a resharded leaf would be another rank's block)."""
        d = self.dispatch
        want = (d.model_axis, d.fsdp_axis, None) if name != "moe_down" \
            else (d.model_axis, None, d.fsdp_axis)
        whole = shardlib.global_shape(x.shape, spec, self.mesh)
        want = shardlib.filter_spec(
            want, whole, {a: self.mesh.axis_size(a)
                          for a in self.mesh.axis_names})
        if tuple(spec) == want:
            return x
        if self.batch_axes is not None:
            raise NotImplementedError(
                f"training {name} split {spec} through moe_dispatch, which "
                f"takes {want}: only the plan's own split is trained")
        return shardlib.shard_leaf(shardlib.gather_leaf(x, spec, self.mesh),
                                   want, self.mesh)

    def batch_sum(self, x):
        """``x`` summed over the batch axes (replicated result)."""
        for a in self.batch_axes or ():
            if self.mesh.axis_size(a) > 1:
                x = collectives.psum(x, self.mesh, a)
        return x

    def batch_moe(self, h, p, cfg: ArchConfig):
        """A MoE layer without the hook on a batch split over the batch
        axes: its tokens gathered, so that it routes the whole batch as
        the reference does (capacity and the load-balance term are
        batch-wide), and the rank's own rows of the output kept.  Every
        rank computes the same aux term, so its gradient is counted once
        over the batch axes."""
        axes = tuple(a for a in self.batch_axes
                     if self.mesh.axis_size(a) > 1)
        rows = (axes if len(axes) > 1 else axes[0],)
        out, aux = moe_layer_3d(shardlib.gather_leaf(h, rows, self.mesh),
                                p["router"], p["moe_gate"], p["moe_up"],
                                p["moe_down"], top_k=cfg.top_k,
                                capacity_factor=cfg.capacity_factor,
                                impl=cfg.moe_impl, ep_shard=cfg.act_shard_moe,
                                seq_chunk=cfg.moe_seq_chunk, remat=cfg.remat)
        # aux's value, with 1/n of its gradient on each of the n ranks.
        n = math.prod(self.mesh.axis_size(a) for a in axes)
        aux = aux.detach() + (aux - aux.detach()) / n
        return shardlib.shard_leaf(out, rows, self.mesh), aux

    def _cache_spec(self, key: str, name: str) -> tuple:
        """A cache leaf's spec for one period and the rank's own batch."""
        spec = list(self.cache[key][name][1:])
        spec[0] = None
        return tuple(spec)

    def cache_read(self, cache, key: str, name: str, n: int):
        """Period ``n``'s cache leaf, gathered whole (over the rank's
        batch)."""
        return shardlib.gather_leaf(cache[key][name][n],
                                    self._cache_spec(key, name), self.mesh)

    def cache_write(self, cache, key: str, name: str, n: int, val,
                    start: int = 0) -> None:
        """Write ``val`` (whole but along dim 1 of the period, where it
        starts at ``start``) into the rank's slice of period ``n``."""
        shardlib.write_local(cache[key][name][n], val,
                             self._cache_spec(key, name), self.mesh,
                             start=start)


def _shard_of(mesh, specs, cfg: ArchConfig) -> "_Shard | None":
    """The rank's view for ``mesh`` (None without one, or with one rank)."""
    if mesh is None or mesh.size == 1:
        return None
    if specs is None:
        raise ValueError("a mesh needs specs= (launch.plan.sharding_specs)")
    batch_axes = specs.get("batch_axes")
    return _Shard(mesh, specs["params"], specs.get("cache"),
                  cfg.moe_dispatch,
                  None if batch_axes is None else tuple(batch_axes))


# ---------------------------------------------------------------------------
# block bodies
# ---------------------------------------------------------------------------
def _project_qkv(p, h, cfg: ArchConfig):
    hd = cfg.resolved_head_dim
    b, s, _ = h.shape
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.use_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], eps=cfg.norm_eps)
    return q, k, v


def _attn_out(p, attn, cfg: ArchConfig, *, prefix: str = ""):
    """The output projection of self-attention, or with ``prefix="x"`` of
    cross-attention."""
    b, s = attn.shape[:2]
    out = attn.reshape(b, s, cfg.n_heads * cfg.resolved_head_dim) \
        @ p[prefix + "wo"]
    if cfg.use_bias:
        out = out + p[prefix + "bo"]
    return out


def _attn_body(p, x, cfg: ArchConfig, *, causal: bool, positions=None,
               norm_key: str = "attn_norm"):
    """Full-sequence attention sub-block (forward / prefill)."""
    h = rms_norm(x, p[norm_key], eps=cfg.norm_eps)
    q, k, v = _project_qkv(p, h, cfg)
    if cfg.rope:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        q = rope(q, positions, theta=cfg.rope_theta)
        k = rope(k, positions, theta=cfg.rope_theta)
    attn = gqa_attention(q, k, v, causal=causal, impl=cfg.attn_impl,
                         q_chunk=cfg.attn_q_chunk,
                         repeat_kv=cfg.attn_repeat_kv)
    return _attn_out(p, attn, cfg), (k, v)


def _cross_query(p, x, cfg: ArchConfig):
    """The cross-attention queries ``[b, s, n_heads, hd]`` of ``x``."""
    h = rms_norm(x, p["xattn_norm"], eps=cfg.norm_eps)
    b, s, _ = h.shape
    q = h @ p["xwq"]
    if cfg.use_bias:
        q = q + p["xbq"]
    return q.reshape(b, s, cfg.n_heads, cfg.resolved_head_dim)


def _encode_cross_kv(p, enc_out, cfg: ArchConfig):
    """A cross block's k/v ``[b, T, n_kv_heads, hd]`` of the encoder
    output."""
    b, t, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = enc_out @ p["xwk"]
    v = enc_out @ p["xwv"]
    if cfg.use_bias:
        k = k + p["xbk"]
        v = v + p["xbv"]
    return (k.reshape(b, t, cfg.n_kv_heads, hd),
            v.reshape(b, t, cfg.n_kv_heads, hd))


def _cross_body(p, x, enc_out, cfg: ArchConfig):
    """Cross-attention against the encoder output (per-layer k/v
    projections): (its output, (k, v))."""
    k, v = _encode_cross_kv(p, enc_out, cfg)
    attn = gqa_attention(_cross_query(p, x, cfg), k, v, causal=False,
                         impl=cfg.attn_impl)
    return _attn_out(p, attn, cfg, prefix="x"), (k, v)


def _mlp_body(p, x, cfg: ArchConfig, kind: str, *, norm_key: str = "mlp_norm",
              shard=None):
    """(MLP output, the MoE load-balance term or None)."""
    h = rms_norm(x, p[norm_key], eps=cfg.norm_eps) if norm_key else x
    if kind == "swiglu":
        return swiglu(h, p["w_gate"], p["w_up"], p["w_down"]), None
    if kind == "gelu":
        bias = cfg.use_bias
        return gelu_mlp(h, p["w_up"], p["b_up"] if bias else None,
                        p["w_down"], p["b_down"] if bias else None), None
    if kind == "relu2":
        z = h @ p["w_up"]
        if cfg.use_bias:
            z = z + p["b_up"]
        out = torch.relu(z).square() @ p["w_down"]
        if cfg.use_bias:
            out = out + p["b_down"]
        return out, None
    if kind == "moe":
        if cfg.moe_dispatch is not None:    # expert-parallel over a mesh
            return cfg.moe_dispatch(
                h, p["router"], p["moe_gate"], p["moe_up"], p["moe_down"],
                top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
        if shard is not None and any(shard.mesh.axis_size(a) > 1
                                     for a in shard.batch_axes or ()):
            return shard.batch_moe(h, p, cfg)
        return moe_layer_3d(h, p["router"], p["moe_gate"], p["moe_up"],
                            p["moe_down"], top_k=cfg.top_k,
                            capacity_factor=cfg.capacity_factor,
                            impl=cfg.moe_impl, ep_shard=cfg.act_shard_moe,
                            seq_chunk=cfg.moe_seq_chunk, remat=cfg.remat)
    raise ValueError(kind)


def _mamba_body(p, x, cfg: ArchConfig, *, return_state: bool = False):
    h = rms_norm(x, p["mamba_norm"], eps=cfg.norm_eps)
    return ssdlib.mamba2_mixer(
        p, h, head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups,
        d_state=cfg.ssm_state, chunk=cfg.ssd_chunk, impl=cfg.ssd_impl,
        return_state=return_state)


def _apply_block(p, x, cfg: ArchConfig, kind: LayerKind, *, causal: bool,
                 positions=None, enc_out=None, collect: bool = False,
                 shard=None):
    """One block; returns (x, its MoE load-balance term or None, what it
    leaves for the cache): ``{"k", "v"}`` of its attention (with
    ``{"xk", "xv"}`` of its cross-attention where it has one and
    ``enc_out`` is given), or with ``collect`` ``{"conv", "ssm"}`` of its
    Mamba mixer, or None."""
    contrib, aux = None, None
    if cfg.parallel_block and kind.mixer == "attn" and kind.mlp != "none":
        # command-r: shared norm, attn & mlp in parallel
        attn_out, (k, v) = _attn_body(p, x, cfg, causal=causal,
                                      positions=positions)
        mlp_out, aux = _mlp_body(p, x, cfg, kind.mlp, norm_key="attn_norm",
                                 shard=shard)
        x = x + attn_out + mlp_out
        contrib = {"k": k, "v": v}
    else:
        if kind.mixer == "attn":
            attn_out, (k, v) = _attn_body(p, x, cfg, causal=causal,
                                          positions=positions)
            x = x + attn_out
            contrib = {"k": k, "v": v}
        elif kind.mixer == "mamba":
            if collect:
                y, (conv_tail, ssm_state) = _mamba_body(p, x, cfg,
                                                        return_state=True)
                contrib = {"conv": conv_tail, "ssm": ssm_state}
            else:
                y = _mamba_body(p, x, cfg)
            x = x + y
        if kind.cross and enc_out is not None:
            cross_out, (xk, xv) = _cross_body(p, x, enc_out, cfg)
            x = x + cross_out
            contrib.update(xk=xk, xv=xv)
        if kind.mlp != "none":
            mlp_out, aux = _mlp_body(p, x, cfg, kind.mlp, shard=shard)
            x = x + mlp_out
    return x, aux, contrib


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------
def _period(stack: dict, key: str, n: int, shard=None) -> dict:
    """Period ``n``'s parameters of position ``key`` (views, no copies):
    ``stack[key]`` maps names to stacked leaves or to their unbound
    periods.  With ``shard``, gathered whole from the rank's shards."""
    if shard is not None:
        return shard.period(stack, key, n)
    return {name: leaf[n] for name, leaf in stack[key].items()}


def _period_blocks(periods, n: int, x, cfg: ArchConfig, plan, *,
                   causal: bool, positions=None, enc_out=None, cache=None,
                   shard=None):
    """Period ``n``'s blocks: (x, the sum of its MoE load-balance terms, or
    None where it has no MoE block).  With ``cache``, each attention
    block's k/v fill its first ``s`` slots, a cross block's k/v of
    ``enc_out`` its period's entries, and each Mamba block's conv tail and
    final SSM state theirs."""
    s = x.shape[1]
    aux = None
    for i, kind in enumerate(plan):
        key = f"p{i}"
        x, a, contrib = _apply_block(_period(periods, key, n, shard), x,
                                     cfg, kind, causal=causal,
                                     positions=positions, enc_out=enc_out,
                                     collect=cache is not None, shard=shard)
        if a is not None:
            aux = a if aux is None else aux + a
        if cache is None or contrib is None:
            continue
        for name, val in contrib.items():
            if shard is not None:
                shard.cache_write(cache, key, name, n, val)
            elif name in ("k", "v"):
                cache[key][name][n, :, :s] = val
            else:
                cache[key][name][n] = val
    return x, aux


def _run_stack(stack, x, cfg: ArchConfig, plan, *, causal: bool,
               positions=None, enc_out=None, cache=None, shard=None):
    """The blocks in order, period by period, cross blocks attending to
    ``enc_out``, filling ``cache`` (from :func:`init_cache`) when one is
    given: (x, the MoE load-balance terms summed over periods, 0.0 without
    MoE).  Without a cache,
    ``cfg.remat`` recomputes each period in backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
    around its period body: the same values, less memory."""
    # Each stacked leaf unbound once: the backward of that one view stacks
    # the periods' gradients in a single pass, where indexing ``leaf[n]``
    # per period would add up ``n_periods`` zero-padded full-size
    # gradients.  A rank of a mesh gathers its shards period by period,
    # inside the checkpoint under ``cfg.remat``: the backward gathers the
    # period again, as FSDP does, so no gathered period outlives its use.
    periods = {key: {name: leaf.unbind(0) for name, leaf in p.items()}
               for key, p in stack.items()}
    auxs = []
    for n in range(cfg.n_layers // len(plan)):
        if cache is None and cfg.remat:
            x, aux = checkpoint(_period_blocks, periods, n, x, cfg, plan,
                                causal=causal, positions=positions,
                                enc_out=enc_out, shard=shard,
                                use_reentrant=False)
        else:
            x, aux = _period_blocks(periods, n, x, cfg, plan, causal=causal,
                                    positions=positions, enc_out=enc_out,
                                    cache=cache, shard=shard)
        if aux is not None:
            auxs.append(aux)
    return x, (torch.stack(auxs).sum() if auxs else 0.0)


def _embed_inputs(params, batch, cfg: ArchConfig, device):
    """tokens (+ the patch stub) -> (x [b,s,D], loss_mask [b,s], positions
    [1,s]): patch embeddings projected by ``patch_proj`` go in front of
    the text, with a loss mask of 0; learned positions count them."""
    tokens = torch.as_tensor(batch["tokens"], device=device).long()
    x = params["embed"][tokens]                     # [b, s_text, D]
    loss_mask = torch.ones(tokens.shape, dtype=torch.float32, device=device)
    if cfg.frontend == "patch" and "patch_embed" in batch:
        patches = torch.as_tensor(batch["patch_embed"], device=device).to(
            x.dtype) @ params["patch_proj"]
        x = torch.cat([patches, x], dim=1)
        loss_mask = torch.cat([torch.zeros(patches.shape[:2],
                                           dtype=torch.float32,
                                           device=device), loss_mask], dim=1)
    if cfg.learned_pos:
        x = x + params["pos_embed"][:x.shape[1]][None]
    positions = torch.arange(x.shape[1], device=device)[None, :]
    return x, loss_mask, positions


def _run_encoder(params, batch, cfg: ArchConfig, device, shard=None):
    """The encoder over the frame stub: frames in ``cfg.dtype`` plus the
    encoder's learned positions, its (non-causal) stack, its final
    norm."""
    enc_cfg = cfg.encoder_cfg()
    frames = torch.as_tensor(batch["frames"], device=device).to(
        _DTYPES[cfg.dtype])                         # [b, T, D]
    enc = params["enc"]
    x = frames + enc["pos_embed"][:frames.shape[1]][None]
    x, _ = _run_stack(enc["stack"], x, enc_cfg,
                      layer_plan(enc_cfg, decoder=False), causal=False,
                      shard=shard and shard.at("enc", "stack"))
    return rms_norm(x, enc["final_norm"], eps=cfg.norm_eps)


class _F32Logits(torch.autograd.Function):
    """``h [n, d] @ w [d, V]`` -> f32 ``[n, V]`` from ``cfg.dtype``
    operands (cuBLAS' ``out_dtype``, f32 accumulation), with a backward:
    ``torch.mm`` has none for ``out_dtype``.  The backward rounds the f32
    logit gradient to the operands' dtype and takes its two products the
    same way (tensor cores, f32 accumulation, results in the operands'
    dtype); the reference multiplies the f32 gradient by the bf16 operand
    in f32, so a bf16 gradient here can differ from it by a bf16 rounding
    of that product's input."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return torch.mm(h, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        gh = gw = None
        if ctx.needs_input_grad[0]:
            gh = torch.mm(g, w.t(), out_dtype=torch.float32).to(h.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(h.t(), g, out_dtype=torch.float32).to(w.dtype)
        return gh, gw


def _lm_head(params, h, cfg: ArchConfig):
    """f32 logits from ``cfg.dtype`` operands, as the reference's
    ``preferred_element_type=f32`` (a bf16 matmul would round the logits to
    bf16).  On the card cuBLAS writes f32 straight from bf16 operands
    (:class:`_F32Logits`), so the [vocab, d] table is never upcast; the CPU
    has no such op, so there both operands are upcast (products of bf16
    values are exact in f32).  A counted step on meta tensors takes the
    card's route."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if h.device.type in ("cuda", "meta") and h.dtype != torch.float32:
        out = _F32Logits.apply(h.reshape(-1, h.shape[-1]), w)
        return out.reshape(*h.shape[:-1], w.shape[-1])
    return h.float() @ w.float()


def _hidden(params, batch, cfg: ArchConfig, device, *, cache=None,
            shard=None):
    """(final-normed hidden states, the loss mask, the MoE load-balance
    term); with ``shard``, every ``stack`` of ``params`` holds a rank's
    shards (the rest gathered by :meth:`_Shard.tops`)."""
    plan = require_ported(cfg)
    x, loss_mask, positions = _embed_inputs(params, batch, cfg, device)
    enc_out = None
    if cfg.enc_layers > 0:
        enc_out = _run_encoder(params, batch, cfg, device, shard)
    x, aux = _run_stack(params["stack"], x, cfg, plan, causal=True,
                        positions=positions, enc_out=enc_out, cache=cache,
                        shard=shard and shard.at("stack"))
    h = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    return h, loss_mask, aux


def _mask_vocab_pad(logits, cfg: ArchConfig):
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    cols = torch.arange(cfg.padded_vocab, device=logits.device)
    return torch.where(cols < cfg.vocab_size, logits, -1e30)


@torch.no_grad()
def forward(params, batch, cfg: ArchConfig, *, device=None, mesh=None,
            specs=None):
    """Full-sequence f32 logits ``[b, s, vocab_size]`` (pad columns sliced
    off); ``s`` counts the patch positions too.  ``mesh``/``specs``: see
    the module's docstring."""
    device = _on_device(params, device)
    shard = _shard_of(mesh, specs, cfg)
    if shard is not None:
        params = shard.tops(params)
    h, _, _ = _hidden(params, batch, cfg, device, shard=shard)
    return _lm_head(params, h, cfg)[..., :cfg.vocab_size]


def _chunk_ce(hc, labels, mask, params, cfg: ArchConfig):
    """Summed masked CE of one sequence chunk: ``hc [b, c, D]``, labels and
    mask ``[b, c]``.  The vocab pad is masked to -1e30 before the
    log-sum-exp, as in the reference."""
    logits = _mask_vocab_pad(_lm_head(params, hc, cfg), cfg)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return ((lse - gold) * mask).sum()


def loss_fn(params, batch, cfg: ArchConfig, *, device=None, mesh=None,
            specs=None):
    """Next-token cross-entropy (f32 scalar), differentiable: the
    counterpart of ``repro.models.lm.loss_fn``.

    ``h`` at position i predicts token i+1; only the text positions
    predict (patch positions in front of the text are left out, as their
    loss mask says).  The CE is taken over sequence
    chunks of ``cfg.loss_chunk`` positions (0: one chunk), the ragged tail
    padded and masked, so the ``[b, s, vocab]`` logits never exist at
    once; each chunk's logits are recomputed in backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
    does.  The sum is divided by the masked count of predicted tokens, and
    ``cfg.moe_aux_weight`` times the MoE layers' summed load-balance term
    is added (0 without MoE).

    On a mesh (see the module's docstring) ``specs`` also names the
    ``batch_axes`` the batch is split over (the training rule of
    :func:`~repro_torch.distributed.sharding.gather_leaf`): ``batch`` is
    the rank's slice, and the CE sum and the token count are summed over
    those axes, so the loss is the whole batch's on every rank, and its
    gradient with respect to each of the rank's shards is the whole
    batch's."""
    device = _on_device(params, device)
    shard = _shard_of(mesh, specs, cfg)
    if shard is not None:
        params = shard.tops(params)
    h, loss_mask, aux = _hidden(params, batch, cfg, device, shard=shard)
    tokens = torch.as_tensor(batch["tokens"], device=device).long()
    s_tot, s_text = h.shape[1], tokens.shape[1]
    h_pred = h[:, s_tot - s_text:][:, :-1]          # [b, s_text-1, D]
    labels = tokens[:, 1:]                          # [b, s_text-1]
    mask = loss_mask[:, s_tot - s_text + 1:]        # mask of label positions
    n = labels.shape[1]
    chunk = min(cfg.loss_chunk, n) if cfg.loss_chunk else n
    pad = (-n) % chunk
    if pad:
        h_pred = torch.nn.functional.pad(h_pred, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=device)
    for c in range(0, n + pad, chunk):
        total = total + checkpoint(
            _chunk_ce, h_pred[:, c:c + chunk], labels[:, c:c + chunk],
            mask[:, c:c + chunk], params, cfg, use_reentrant=False)
    count = mask.sum()
    if shard is not None:
        total, count = shard.batch_sum(total), shard.batch_sum(count)
    return total / torch.clamp(count, min=1.0) + cfg.moe_aux_weight * aux


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device=None):
    """The zeroed serving cache for a batch of sequences of ≤ ``max_len``
    tokens, per period position: an attention block's ``{"k", "v":
    [n_periods, batch, max_len, n_kv_heads, hd]}`` in ``cfg.dtype``, and a
    cross block's ``{"xk", "xv": [n_periods, batch, frontend_len,
    n_kv_heads, hd]}`` beside them; a Mamba block's ``{"conv": [n_periods,
    batch, conv_k - 1, conv_dim]}`` in ``cfg.dtype`` and ``{"ssm":
    [n_periods, batch, heads, head_dim, state]}`` in f32."""
    return _new_cache(cfg, batch, max_len, cfg.frontend_len,
                      resolve_device(device))


def _new_cache(cfg: ArchConfig, batch: int, max_len: int, enc_len: int,
               device):
    """:func:`init_cache` with the cross k/v sized for ``enc_len`` encoder
    frames."""
    plan = require_ported(cfg)
    n_periods = cfg.n_layers // len(plan)
    hd = cfg.resolved_head_dim
    dtype = _DTYPES[cfg.dtype]

    def zeros(length):
        return torch.zeros((n_periods, batch, length, cfg.n_kv_heads, hd),
                           dtype=dtype, device=device)

    cache = {}
    for i, kind in enumerate(plan):
        if kind.mixer == "attn":
            cache[f"p{i}"] = {"k": zeros(max_len), "v": zeros(max_len)}
            if kind.cross:
                cache[f"p{i}"].update(xk=zeros(enc_len), xv=zeros(enc_len))
        elif kind.mixer == "mamba":
            mc = ssdlib.mamba2_init_cache(
                batch, d_inner=cfg.d_inner, head_dim=cfg.ssm_head_dim,
                n_groups=cfg.ssm_groups, d_state=cfg.ssm_state,
                conv_k=cfg.ssm_conv, dtype=dtype, device=device)
            cache[f"p{i}"] = {
                name: leaf[None].expand((n_periods,) + leaf.shape).clone()
                for name, leaf in mc._asdict().items()}
    return cache


@torch.no_grad()
def prefill(params, batch, cfg: ArchConfig, *, max_len: int | None = None,
            device=None, mesh=None, specs=None):
    """Process the whole prompt; return (last-position logits ``[b,
    padded_vocab]`` f32 with pad columns at -1e30, cache).  The prompt is
    ``s`` positions: the patches (if any) and the tokens.  The cache holds
    its k/v in the first ``s`` slots, each cross block's k/v of the
    encoder output, and each Mamba block's conv tail and SSM state after
    the prompt, so :func:`decode_step` continues at ``pos = s``.  On a
    mesh the cache is the rank's shard under ``specs["cache"]`` (the
    specs of the whole batch's cache of ``max_len``)."""
    device = _on_device(params, device)
    shard = _shard_of(mesh, specs, cfg)
    b, s = batch["tokens"].shape
    if cfg.frontend == "patch" and "patch_embed" in batch:
        s += batch["patch_embed"].shape[1]
    enc_len = batch["frames"].shape[1] if cfg.enc_layers > 0 else 0
    if shard is None:
        cache = _new_cache(cfg, b, max_len or s, enc_len, device)
    else:
        params = shard.tops(params)
        cache = _local_cache(cfg, b, max_len or s, enc_len, device, shard)
    h, _, _ = _hidden(params, batch, cfg, device, cache=cache, shard=shard)
    logits = _lm_head(params, h[:, -1:, :], cfg)[:, 0]
    return _mask_vocab_pad(logits, cfg), cache


def _local_cache(cfg: ArchConfig, b: int, max_len: int, enc_len: int,
                 device, shard: _Shard) -> dict:
    """A rank's zeroed shard of the cache of the whole batch, whose specs
    ``shard.cache`` are: ``b`` is the rank's share of the batch."""
    some = next(iter(next(iter(shard.cache.values())).values()))
    n_batch = shardlib.global_shape((b,), some[1:2], shard.mesh)[0]
    whole = _new_cache(cfg, n_batch, max_len, enc_len, "meta")
    return {key: {name: torch.zeros(
        shardlib.local_shape(leaf.shape, shard.cache[key][name], shard.mesh),
        dtype=leaf.dtype, device=device) for name, leaf in block.items()}
        for key, block in whole.items()}


def _decode_attn_block(p, x_t, c, n: int, cfg: ArchConfig, pos: int):
    """x_t [b,1,D]; writes this token's k/v into slot ``pos`` of period
    ``n`` of ``c`` and attends over slots ``<= pos``."""
    h = rms_norm(x_t, p["attn_norm"], eps=cfg.norm_eps)
    q, k, v = _project_qkv(p, h, cfg)
    if cfg.rope:
        posb = torch.full((x_t.shape[0], 1), pos, device=x_t.device)
        q = rope(q, posb, theta=cfg.rope_theta)
        k = rope(k, posb, theta=cfg.rope_theta)
    kc, vc = c["k"][n], c["v"][n]
    kc[:, pos:pos + 1] = k
    vc[:, pos:pos + 1] = v
    mask = (torch.arange(kc.shape[1], device=x_t.device) <= pos).float()
    return _attn_out(p, decode_attention(q, kc, vc, mask), cfg)


def _decode_cross_block(p, x_t, c, n: int, cfg: ArchConfig):
    """x_t [b,1,D]; attends to period ``n``'s cached encoder k/v."""
    return _attn_out(p, decode_attention(_cross_query(p, x_t, cfg),
                                         c["xk"][n], c["xv"][n], None),
                     cfg, prefix="x")


def _decode_mamba_block(p, x_t, c, n: int, cfg: ArchConfig):
    """x_t [b,1,D]; advances period ``n``'s conv window and SSM state in
    ``c`` by this token, in place."""
    h = rms_norm(x_t, p["mamba_norm"], eps=cfg.norm_eps)
    y, mc = ssdlib.mamba2_decode_step(
        p, h[:, 0], ssdlib.MambaCache(conv=c["conv"][n], ssm=c["ssm"][n]),
        head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups,
        d_state=cfg.ssm_state)
    c["conv"][n].copy_(mc.conv)
    c["ssm"][n].copy_(mc.ssm)
    return y[:, None, :]


@torch.no_grad()
def decode_step(params, cache, tokens, pos, cfg: ArchConfig, *, device=None,
                mesh=None, specs=None):
    """One-token decode.  tokens ``[b, 1]``; ``pos`` the slot of the new
    token (an int).  Returns (logits ``[b, padded_vocab]`` f32 with pad
    columns at -1e30, cache) — the same cache object, updated in place.
    MoE layers run dropless here: ``b`` tokens at ``capacity_factor =
    n_experts / top_k`` give every expert room for all of them.  On a
    mesh, ``cache`` is the rank's shard from :func:`prefill`."""
    device = _on_device(params, device)
    plan = require_ported(cfg)
    if cfg.moe:
        cfg = replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    shard = _shard_of(mesh, specs, cfg)
    if shard is not None:
        params = shard.tops(params)
    pos = int(pos)
    tokens = torch.as_tensor(tokens, device=device).long()
    x = params["embed"][tokens]                     # [b,1,D]
    if cfg.learned_pos:
        x = x + params["pos_embed"][pos:pos + 1][None]
    stack = params["stack"]
    sh = shard and shard.at("stack")
    for n in range(cfg.n_layers // len(plan)):
        for i, kind in enumerate(plan):
            key = f"p{i}"
            p = _period(stack, key, n, sh)
            c, m = cache.get(key), n
            if sh is not None and c is not None:
                # The period's cache gathered whole, written back after.
                c = {name: sh.cache_read(cache, key, name, n)[None]
                     for name in c}
                m = 0
            if cfg.parallel_block and kind.mixer == "attn" \
                    and kind.mlp != "none":
                attn_out = _decode_attn_block(p, x, c, m, cfg, pos)
                mlp_out, _ = _mlp_body(p, x, cfg, kind.mlp,
                                       norm_key="attn_norm")
                x = x + attn_out + mlp_out
            else:
                if kind.mixer == "attn":
                    x = x + _decode_attn_block(p, x, c, m, cfg, pos)
                elif kind.mixer == "mamba":
                    x = x + _decode_mamba_block(p, x, c, m, cfg)
                if kind.cross:
                    x = x + _decode_cross_block(p, x, c, m, cfg)
                if kind.mlp != "none":
                    x = x + _mlp_body(p, x, cfg, kind.mlp)[0]
            if sh is not None and c is not None:
                _write_back(sh, cache, key, n, c, kind, pos)
    h = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    logits = _lm_head(params, h, cfg)[:, 0]
    return _mask_vocab_pad(logits, cfg), cache


def _write_back(shard: _Shard, cache, key: str, n: int, c: dict,
                kind: LayerKind, pos: int) -> None:
    """What a decode step changed in period ``n``'s gathered cache ``c``,
    into the rank's slices: the new token's k/v slot, the Mamba conv window
    and SSM state."""
    if kind.mixer == "attn":
        for name in ("k", "v"):
            shard.cache_write(cache, key, name, n, c[name][0][:, pos:pos + 1],
                              start=pos)
    elif kind.mixer == "mamba":
        for name in ("conv", "ssm"):
            shard.cache_write(cache, key, name, n, c[name][0])
