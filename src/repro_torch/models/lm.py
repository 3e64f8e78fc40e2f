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
rank) and ``specs`` (the filtered specs of
:func:`repro_torch.launch.plan.sharding_specs`: ``"params"``, a serve
step's ``"cache"``, and the layouts ``"act"`` and ``"logits"``; a training
step's lane specs also name its ``"batch_axes"``).  Each rank holds its
shard of every parameter, its shard of the batch (split over the batch
axes) and its shard of the cache.  Where the specs carry a ``"logits"``
layout (``model`` is no worker axis) the layers are split over ``model``
as Megatron splits them, which is what the reference's layout hooks make
XLA do:

* attention computes the rank's ``n_heads / |model|`` query heads and their
  kv heads (``wq``/``wk``/``wv`` by column, ``wo`` by row; where
  ``n_kv_heads`` does not divide, ``wk``/``wv`` whole and the kv heads its
  query heads need picked), the dense MLPs the rank's columns of ``d_ff``,
  a MoE layer without the dispatch its block of the expert buffers where
  the config carries the ``act_shard_moe`` split (every token routed on
  every rank; the rank's ``E / |model|`` experts, gathered over the FSDP
  axis only, or where the experts do not divide the rank's block of each
  expert's capacity rows), else (the ``tp`` policy, whose specs split each
  expert's ``F``) the rank's slice of each expert's ``F``, and the
  embedding, head and cross-entropy the rank's rows of the vocabulary;
  each row-parallel product (and each rank's contribution to a MoE
  layer's output) is summed over ``model``;
* between blocks the residual stream has the ``"act"`` layout: under
  ``seq_axes = ("model",)`` (sequence parallelism, the large archs) each
  rank holds its block of the sequence, a split block gathers the
  sequence at its entry and reduce-scatters its output over it; else the
  stream is whole on every rank and the output is all-reduced;
* the Mamba-2 mixer computes the rank's ``H / |model|`` heads where they,
  its packed in-projection's columns and its conv channels divide: the
  rank's column block of the in-projection is all-gathered into the whole
  projection, the conv, SSD and gated norm (its sum of squares summed over
  ``model``) run on the rank's heads and ``mamba_out``'s rows give a
  partial sum (:class:`~repro_torch.models.ssd.HeadSplit`);
* MoE layers through ``cfg.moe_dispatch`` (which take the rank's own
  experts), cross-attention, and a layer whose heads do not divide are
  computed whole, as on one card, from their layers' weights all-gathered
  over every axis their specs name, one layer at a time; under sequence
  parallelism on the stream gathered over the sequence, the rank's block
  kept after;
* ``decode_step`` reads and writes the rank's own cache shards: where the
  cache's slots are split over ``model``, each rank attends over its own
  and the ranks' partial softmaxes are combined (flash-decode); a split
  Mamba mixer advances its heads' SSM state and its block of the conv
  window;
* ``forward``, ``prefill`` and ``decode_step`` return the rank's slice of
  the padded vocabulary (pad columns at -1e30); :func:`gather_logits`
  puts the whole back.  The logits are the rank's batch's.

A rank whose layers are not split (the per-chip workers: ``model`` is a
worker axis) computes every layer whole.  Under ``cfg.remat`` a period's
gathers run inside its checkpoint, so the backward gathers it again.

**Gradients.**  A training rank's batch is split over the batch axes.  A
leaf gathered over an axis sums its gradient over it where that axis
splits the data the leaf is used on (the batch axes, and ``model`` where
the leaf is used on the rank's block of the sequence or its part of a
split product: the norms and output biases under sequence parallelism,
qk-norm, a kv projection taken whole, the router of a split MoE, the
experts a MoE layer split by capacity takes whole, a split Mamba mixer's
``mamba_conv`` and ``mamba_gnorm``), as
:func:`~repro_torch.distributed.sharding.gather_leaf`'s training rule
does; over any other axis each rank's cotangent already is the whole
gradient.  The split leaves are never gathered over ``model``: each rank's
cotangent is exactly its own block's gradient.  Without the dispatch a
training rank gathers the batch's tokens for a MoE layer's routing.  A
mesh of one rank is the path without a mesh.
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
from repro_torch.models.layers import (combine_decode_partials,
                                       decode_attention,
                                       decode_attention_partial, dense_init,
                                       gelu_mlp, gqa_attention, moe_layer_3d,
                                       norm_init, rms_norm, rope, swiglu)

__all__ = ["init_params", "param_shapes", "leaf_dtype", "forward", "loss_fn",
           "init_cache", "prefill", "decode_step", "gather_logits",
           "layer_plan", "LayerKind", "param_count"]

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


def _parallel(cfg: ArchConfig, kind: LayerKind) -> bool:
    """Whether a block runs its attention and MLP in parallel on one norm
    (command-r)."""
    return cfg.parallel_block and kind.mixer == "attn" and kind.mlp != "none"


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
        "stack": _stack_shapes(cfg, layer_plan(cfg)),
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


# Leaves a split block keeps as the rank's block over ``model``, by the dim
# of a period's leaf that is split: the attention's columns (q, and k/v
# where the kv heads divide) and rows; the dense MLPs' columns and rows; a
# MoE layer's F, or under the experts split its experts.
_ATTN_SPLIT = {"wq": 1, "wo": 0, "bq": 0}
_KV_SPLIT = {"wk": 1, "wv": 1, "bk": 0, "bv": 0}
_MLP_SPLIT = {"w_gate": 1, "w_up": 1, "w_down": 0, "b_up": 0}
_MOE_SPLIT = {"moe_gate": 2, "moe_up": 2, "moe_down": 1}
_MOE_EXPERTS = {"moe_gate": 0, "moe_up": 0, "moe_down": 0}
_MAMBA_SPLIT = {"mamba_in": 1, "mamba_out": 0, "mamba_A": 0,
                "mamba_dt_bias": 0, "mamba_D": 0}


@dataclass(frozen=True)
class _Shard:
    """A rank's view of a client split over a mesh: the mesh, the parameter
    specs of the subtree at hand, the cache specs, the expert-parallel hook
    (its expert leaves stay local), in a training step the axes its batch
    is split over (``None`` when serving: see
    :func:`~repro_torch.distributed.sharding.gather_leaf`), and the split
    over ``model`` (see the module's docstring): ``tp`` the axis the
    layers are split over (None: every layer whole), ``vocab`` whether the
    embedding and head are split over the vocabulary, ``sp`` whether the
    plan splits the residual stream over the sequence, ``seq`` whether
    this call's stream is split (its length divides), and ``experts`` the
    ``act_shard_moe`` split of the MoE layers' expert buffers over ``tp``
    (None: each expert's ``F`` split where it divides)."""

    mesh: object
    specs: dict
    cache: dict | None
    dispatch: object = None
    batch_axes: tuple | None = None
    tp: str | None = None
    vocab: bool = False
    sp: bool = False
    seq: bool = False
    experts: object = None

    @property
    def m(self) -> int:
        return self.mesh.axis_size(self.tp) if self.tp else 1

    @property
    def r(self) -> int:
        return self.mesh.axis_index(self.tp) if self.tp else 0

    def at(self, *keys) -> "_Shard":
        specs = self.specs
        for k in keys:
            specs = specs[k]
        return replace(self, specs=specs)

    def for_length(self, s: int) -> "_Shard":
        """This shard for a stream of ``s`` positions: split over the
        sequence where the plan asks and ``s`` divides."""
        return replace(self, seq=self.sp and s % self.m == 0)

    def gather(self, x, spec, *, batch_axes=None):
        return shardlib.gather_leaf(
            x, spec, self.mesh,
            batch_axes=self.batch_axes if batch_axes is None else batch_axes)

    def _plus_tp(self):
        """A training rank's batch axes and ``tp``: the axes over which a
        leaf used on the rank's part of a split computation sums its
        gradient (None when serving)."""
        if self.batch_axes is None:
            return None
        return tuple(self.batch_axes) + (self.tp,)

    def local(self, x, spec, dim: int):
        """The rank's block over ``tp`` along ``dim`` of a leaf, gathered
        over its other axes.  Where the spec does not split ``dim`` over
        ``tp`` alone (an axis it does not divide, or another dim) the leaf
        is gathered whole and sliced: its gradient then sums over ``tp``
        (the other ranks' blocks are zero in this rank's)."""
        if shardlib._entry_axes(spec[dim]) == (self.tp,):
            return self.gather(x, tuple(None if i == dim else e
                                        for i, e in enumerate(spec)))
        whole = self.gather(x, spec, batch_axes=self._plus_tp())
        n = whole.shape[dim] // self.m
        # A block of its own: the whole leaf is freed here.
        return whole.narrow(dim, self.r * n, n).contiguous()

    def tops(self, params, specs=None) -> dict:
        """``params`` with every leaf outside a ``stack`` gathered whole;
        the embedding and head the rank's rows of the vocabulary where it
        is split.  The encoder's stream is never split over the
        sequence."""
        specs = self.specs if specs is None else specs
        enc = replace(self, vocab=False, seq=False)
        out = {}
        for k, v in params.items():
            if k == "stack":
                out[k] = v
            elif isinstance(v, dict):
                out[k] = enc.tops(v, specs[k])
            elif self.vocab and k in ("embed", "lm_head"):
                out[k] = self.local(v, specs[k], 0 if k == "embed" else 1)
            elif self.seq and k == "final_norm":
                out[k] = self.gather(v, specs[k], batch_axes=self._plus_tp())
            else:
                out[k] = self.gather(v, specs[k])
        return out

    # -- the split over ``tp`` ---------------------------------------------
    def attn_split(self, cfg: ArchConfig, kind: LayerKind) -> bool:
        """Whether this block's attention is split over ``tp`` (its heads
        divide; in a parallel block, with its MLP)."""
        if self.tp is None or kind.mixer != "attn" \
                or cfg.n_heads % self.m:
            return False
        return not _parallel(cfg, kind) or self._mlp_divides(cfg, kind)

    def mlp_split(self, cfg: ArchConfig, kind: LayerKind) -> bool:
        """Whether this block's MLP is split over ``tp``: a dense MLP whose
        ``d_ff`` divides, or a MoE layer without the dispatch under the
        experts split or whose experts' ``F`` divides (in a parallel block,
        with its attention)."""
        if self.tp is None or not self._mlp_divides(cfg, kind):
            return False
        return not _parallel(cfg, kind) or cfg.n_heads % self.m == 0

    def _mlp_divides(self, cfg: ArchConfig, kind: LayerKind) -> bool:
        if kind.mlp in ("swiglu", "gelu", "relu2"):
            return cfg.d_ff % self.m == 0
        return kind.mlp == "moe" and self.dispatch is None \
            and (self.experts is not None or cfg.moe_d_ff % self.m == 0)

    def kv_split(self, cfg: ArchConfig) -> bool:
        return cfg.n_kv_heads % self.m == 0

    def mamba_split(self, cfg: ArchConfig, kind: LayerKind) -> bool:
        """Whether this block's Mamba-2 mixer is split over ``tp`` by heads:
        its heads, the in-projection's columns and the conv channels
        divide (so the plan's specs split ``mamba_in``'s columns over
        ``tp`` alone), and each rank's heads read whole groups of ``B``/
        ``C`` or lie in one group."""
        if self.tp is None or kind.mixer != "mamba":
            return False
        h, g, m = cfg.ssm_heads, cfg.ssm_groups, self.m
        width = 2 * cfg.d_inner + 2 * g * cfg.ssm_state + h
        conv = cfg.d_inner + 2 * g * cfg.ssm_state
        hl, hpg = h // m, h // g
        return h % m == 0 and width % m == 0 and conv % m == 0 \
            and (hl % hpg == 0 or hpg % hl == 0)

    def heads(self) -> "ssdlib.HeadSplit":
        """The rank's share of a split Mamba-2 mixer: the ranks' column
        blocks gathered over ``tp`` (the backward a reduce-scatter), the
        gated norm's sums of squares totalled over ``tp`` with their
        gradient summed (each rank's total feeds only its own heads, so a
        plain :func:`~repro_torch.distributed.collectives.psum`, whose
        backward passes the cotangent through, would drop the other
        ranks' parts of it)."""
        mesh, tp = self.mesh, self.tp
        return ssdlib.HeadSplit(
            self.r, self.m,
            lambda t: collectives.all_gather(t, mesh, tp, dim=t.ndim - 1),
            lambda t: collectives.sum_grad(collectives.psum(t, mesh, tp),
                                           mesh, (tp,)))

    def _split_leaves(self, cfg: ArchConfig, kind: LayerKind):
        """``({name: split dim}, names whose gradient sums over tp)`` of a
        period of this kind."""
        split, summed = {}, set()
        if self.attn_split(cfg, kind):
            split.update(_ATTN_SPLIT)
            summed |= {"q_norm", "k_norm"}
            if self.kv_split(cfg):
                split.update(_KV_SPLIT)
            else:
                summed |= set(_KV_SPLIT)
            if self.seq:
                summed |= {"attn_norm", "bo"}
        if self.mlp_split(cfg, kind):
            if kind.mlp == "moe":
                summed.add("router")
                if self.experts is None:
                    split.update(_MOE_SPLIT)
                elif cfg.n_experts % self.m == 0:
                    split.update(_MOE_EXPERTS)
                else:       # whole: each rank its capacity rows (or rank 0)
                    summed |= set(_MOE_LEAVES)
            else:
                split.update(_MLP_SPLIT)
            if self.seq:
                summed |= {"mlp_norm", "b_down"}
        if self.mamba_split(cfg, kind):
            split.update(_MAMBA_SPLIT)
            summed |= {"mamba_conv", "mamba_gnorm"}
            if self.seq:
                summed.add("mamba_norm")
        return split, summed

    def period(self, stack, key: str, n: int, cfg: ArchConfig,
               kind: LayerKind, *, decode: bool = False) -> dict:
        """Period ``n``'s leaves of position ``key``: those of a split
        block the rank's blocks, the others gathered whole; with the hook,
        its experts as the hook takes them.  ``stack[key]`` maps names to
        stacked leaves or to their unbound periods.  A decode step's split
        Mamba mixer takes the rank's block of ``mamba_conv``'s channels,
        those of its block of the conv window."""
        split, summed = self._split_leaves(cfg, kind)
        if decode and "mamba_in" in split:
            split["mamba_conv"] = 1
        out = {}
        for name, leaf in stack[key].items():
            spec = self.specs[key][name][1:]
            if name in split:
                out[name] = self.local(leaf[n], spec, split[name])
            elif self.dispatch is not None and name in _MOE_LEAVES:
                out[name] = self._experts(leaf[n], spec, name)
            elif self.dispatch is not None and name == "router" \
                    and self.batch_axes is not None:
                # The hook sums the router's cotangent over every axis.
                out[name] = self.gather(leaf[n], spec, batch_axes=())
            elif name in summed:
                out[name] = self.gather(leaf[n], spec,
                                        batch_axes=self._plus_tp())
            else:
                out[name] = self.gather(leaf[n], spec)
        return out

    def enter(self, h):
        """A split block's input: gathered over the sequence (its backward
        a reduce-scatter), or the stream itself with Megatron's "f"."""
        if self.seq:
            return collectives.all_gather(h, self.mesh, self.tp, dim=1)
        return collectives.sum_grad(h, self.mesh, (self.tp,))

    def leave(self, y):
        """A split block's output, the ranks' partial products summed:
        reduce-scattered over the sequence, or all-reduced (Megatron's
        "g")."""
        if self.seq:
            return collectives.reduce_scatter(y, self.mesh, self.tp, dim=1)
        return collectives.psum(y, self.mesh, self.tp)

    def whole_in(self, x):
        """A block computed whole: the stream gathered over the sequence,
        each rank's cotangent of it the whole gradient."""
        if self.seq:
            return collectives.all_gather(x, self.mesh, self.tp, dim=1,
                                          sum_grad=False)
        return x

    def whole_out(self, y):
        """A whole block's output, the rank's block of the sequence."""
        if self.seq:
            return collectives.split(y, self.mesh, self.tp, dim=1)
        return y

    def head_in(self, h):
        """The final hidden states, whole over the sequence, as the head
        takes them: a split head's partial products count each rank's
        cotangent."""
        if self.tp is None:
            return h
        if self.seq:
            return collectives.all_gather(h, self.mesh, self.tp, dim=1,
                                          sum_grad=self.vocab)
        if self.vocab:
            return collectives.sum_grad(h, self.mesh, (self.tp,))
        return h

    def last(self, h):
        """The last position's hidden state ``[b, 1, D]``: under sequence
        parallelism it lies on the last rank, and is summed over ``tp``
        from there."""
        if not self.seq:
            return h[:, -1:]
        return collectives.psum(h[:, -1:] * float(self.r == self.m - 1),
                                self.mesh, self.tp)

    def kv_heads(self, k, cfg: ArchConfig):
        """From k (or v) of every kv head ``[b, t, n_kv_heads, hd]``, the
        heads this rank's query heads attend to: its block where the kv
        heads divide, else each of its query heads' kv head (the plan's
        ``attn_repeat_kv`` repeat, taken for the rank's heads only)."""
        if self.kv_split(cfg):
            n = cfg.n_kv_heads // self.m
            return k.narrow(2, self.r * n, n)
        hq = cfg.n_heads // self.m
        group = cfg.n_heads // cfg.n_kv_heads
        idx = (self.r * hq + torch.arange(hq, device=k.device)) // group
        return k.index_select(2, idx)

    def all_heads(self, k, cfg: ArchConfig):
        """A split attention's k or v ``[b, t, heads, hd]`` with every kv
        head, as the cache holds them."""
        if not self.kv_split(cfg):
            return k
        return collectives.all_gather(k, self.mesh, self.tp, dim=2)

    def split_aux(self, aux):
        """A split MoE layer's load-balance term: every rank computes the
        same value; its gradient is counted once over ``tp``."""
        return aux.detach() + (aux - aux.detach()) / self.m

    # -- the rest ------------------------------------------------------------
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

    def batch_split(self) -> bool:
        return any(self.mesh.axis_size(a) > 1 for a in self.batch_axes or ())

    def batch_sum(self, x):
        """``x`` summed over the batch axes (replicated result)."""
        for a in self.batch_axes or ():
            if self.mesh.axis_size(a) > 1:
                x = collectives.psum(x, self.mesh, a)
        return x

    def batch_moe(self, h, p, cfg: ArchConfig, experts=None):
        """A MoE layer without the hook on a batch split over the batch
        axes: its tokens gathered, so that it routes the whole batch as
        the reference does (capacity and the load-balance term are
        batch-wide), and the rank's own rows of the output kept (with
        ``experts``, of its contribution).  Every rank computes the same
        aux term, so its gradient is counted once over the batch axes."""
        axes = tuple(a for a in self.batch_axes
                     if self.mesh.axis_size(a) > 1)
        rows = (axes if len(axes) > 1 else axes[0],)
        out, aux = moe_layer_3d(shardlib.gather_leaf(h, rows, self.mesh),
                                p["router"], p["moe_gate"], p["moe_up"],
                                p["moe_down"], top_k=cfg.top_k,
                                capacity_factor=cfg.capacity_factor,
                                impl=cfg.moe_impl, ep_shard=experts,
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

    def _cache_axes(self, key: str, name: str, dim: int) -> tuple:
        return shardlib._entry_axes(self._cache_spec(key, name)[dim])

    def in_place(self, cfg: ArchConfig, kind: LayerKind, key: str) -> bool:
        """Whether a decode step reads and writes period position ``key``'s
        cache in the rank's own shards: an attention block's slots (and its
        cross-attention's frames) whole or split over ``tp``, a split
        Mamba mixer's blocks of the conv channels and SSM heads (the
        specs must split them over ``tp``).  Else the period's cache is
        gathered whole and written back after."""
        if self.tp is None:
            return False
        if kind.mixer == "mamba":
            if not self.mamba_split(cfg, kind):
                return False
            if any(self._cache_axes(key, name, d) != (self.tp,)
                   for name, d in (("conv", 2), ("ssm", 1))):
                raise ValueError(
                    f"{key}: a Mamba mixer split over {self.tp} needs the "
                    f"cache specs to split its conv channels and SSM heads "
                    f"over {self.tp}")
            return True
        return all(self._cache_axes(key, name, 1) in ((), (self.tp,))
                   for name in self.cache[key])

    def slots_split(self, key: str, name: str) -> bool:
        """Whether the slots of the cache leaf ``name`` are split over
        ``tp``."""
        return self._cache_axes(key, name, 1) == (self.tp,)

    def combine(self, part, *, own_heads: bool):
        """The flash-decode combine over ``tp`` of the ranks' partial
        softmaxes ``part`` (:func:`~repro_torch.models.layers
        .decode_attention_partial` over each rank's slots, every query
        head): the maxima and the weighted outputs and sums all-reduced,
        of which the rank keeps its own query heads with ``own_heads``."""
        mesh, tp = self.mesh, self.tp
        out = combine_decode_partials(
            *part, pmax=lambda t: collectives.pmax(t, mesh, tp),
            psum=lambda t: collectives.psum(t, mesh, tp))
        if not own_heads:
            return out
        n = out.shape[2] // self.m
        return out.narrow(2, self.r * n, n)

    def cache_read(self, c: dict, key: str, name: str, n: int):
        """Period ``n``'s leaf ``name`` of ``c`` (the cache of position
        ``key``), gathered whole (over the rank's batch)."""
        return shardlib.gather_leaf(c[name][n], self._cache_spec(key, name),
                                    self.mesh)

    def cache_write(self, c: dict, key: str, name: str, n: int, val,
                    start: int = 0) -> None:
        """Write ``val`` (whole but along dim 1 of the period, where it
        starts at ``start``) into the rank's slice of period ``n`` of
        ``c``, the cache of position ``key``."""
        shardlib.write_local(c[name][n], val, self._cache_spec(key, name),
                             self.mesh, start=start)


def _shard_of(mesh, specs, cfg: ArchConfig) -> "_Shard | None":
    """The rank's view for ``mesh`` (None without one, or with one rank):
    the layers split over ``model`` where ``specs`` carry a ``"logits"``
    layout and ``model`` has several ranks, the vocabulary too where that
    layout splits it and the padded vocabulary divides, the stream over
    the sequence where the ``"act"`` layout names ``model``."""
    if mesh is None or mesh.size == 1:
        return None
    if specs is None:
        raise ValueError("a mesh needs specs= (launch.plan.sharding_specs)")
    batch_axes = specs.get("batch_axes")
    tp = "model" if "logits" in specs and "model" in mesh.axis_names \
        and mesh.axis_size("model") > 1 else None
    seq_axes = shardlib._entry_axes(specs["act"][1]) if "act" in specs else ()
    if seq_axes and seq_axes != (tp,):
        raise NotImplementedError(
            f"the stream split over {seq_axes}: only over the layers' "
            f"model axis ({tp}) is ported")
    m = mesh.axis_size(tp) if tp else 1
    vocab = tp is not None and tp in shardlib._entry_axes(specs["logits"][-1]) \
        and cfg.padded_vocab % m == 0
    experts = None
    if tp is not None and cfg.act_shard_moe is not None \
            and cfg.moe_dispatch is None and cfg.moe_impl == "scatter" \
            and not _experts_f_split(specs["params"], tp):
        experts = shardlib.ExpertSplit(mesh, tp)
    return _Shard(mesh, specs["params"], specs.get("cache"),
                  cfg.moe_dispatch,
                  None if batch_axes is None else tuple(batch_axes),
                  tp=tp, vocab=vocab, sp=bool(seq_axes), experts=experts)


def _experts_f_split(specs, tp: str) -> bool:
    """Whether the parameter ``specs`` split the experts' ``F`` over ``tp``
    (the ``tp`` policy), which the MoE layers then keep."""
    for p in specs.get("stack", {}).values():
        if "moe_gate" in p:
            return tp in shardlib._entry_axes(p["moe_gate"][3])
    return False


def gather_logits(logits, cfg: ArchConfig, *, mesh=None, specs=None):
    """The whole (padded) vocabulary's logits from a rank's slice, as
    :func:`forward`, :func:`prefill` and :func:`decode_step` return it on
    a mesh whose ``"logits"`` layout splits the vocabulary (gathered over
    ``model`` along the last dim); ``logits`` itself elsewhere."""
    shard = _shard_of(mesh, specs, cfg)
    if shard is None or not shard.vocab:
        return logits
    return collectives.all_gather(logits, mesh, shard.tp, dim=logits.ndim - 1)


# ---------------------------------------------------------------------------
# block bodies
# ---------------------------------------------------------------------------
def _project_qkv(p, h, cfg: ArchConfig):
    """q, k, v ``[b, s, heads, hd]`` of ``h``: as many heads as the
    projections hold (a rank of a split attention holds its own)."""
    hd = cfg.resolved_head_dim
    b, s, _ = h.shape
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.use_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], eps=cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], eps=cfg.norm_eps)
    return q, k, v


def _attn_out(p, attn, cfg: ArchConfig, *, prefix: str = "",
              bias: bool = True):
    """The output projection of self-attention, or with ``prefix="x"`` of
    cross-attention; ``bias=False`` leaves the bias out (a split
    attention adds it after the sum over ranks)."""
    b, s = attn.shape[:2]
    out = attn.reshape(b, s, -1) @ p[prefix + "wo"]
    if cfg.use_bias and bias:
        out = out + p[prefix + "bo"]
    return out


def _attn_core(p, h, cfg: ArchConfig, *, causal: bool, positions=None,
               shard=None):
    """Full-sequence attention of the normed ``h``: (its output projection
    without the bias, (k, v)).  With ``shard`` (a split attention) the
    rank's heads: its kv heads picked where ``wk``/``wv`` are whole, and
    the output a partial sum."""
    q, k, v = _project_qkv(p, h, cfg)
    if cfg.rope:
        if positions is None:
            positions = torch.arange(h.shape[1], device=h.device)[None, :]
        q = rope(q, positions, theta=cfg.rope_theta)
        k = rope(k, positions, theta=cfg.rope_theta)
    kq, vq = k, v
    if shard is not None and not shard.kv_split(cfg):
        kq, vq = shard.kv_heads(k, cfg), shard.kv_heads(v, cfg)
    attn = gqa_attention(q, kq, vq, causal=causal, impl=cfg.attn_impl,
                         q_chunk=cfg.attn_q_chunk,
                         repeat_kv=cfg.attn_repeat_kv)
    return _attn_out(p, attn, cfg, bias=False), (k, v)


def _attn_body(p, x, cfg: ArchConfig, *, causal: bool, positions=None,
               norm_key: str = "attn_norm"):
    """Full-sequence attention sub-block (forward / prefill)."""
    h = rms_norm(x, p[norm_key], eps=cfg.norm_eps)
    out, kv = _attn_core(p, h, cfg, causal=causal, positions=positions)
    return _bias(out, p, cfg, "bo"), kv


def _bias(y, p, cfg: ArchConfig, *names):
    """``y`` plus the biases ``names`` of ``p`` where the config has
    biases and ``p`` holds them."""
    if cfg.use_bias:
        for name in names:
            if name in p:
                y = y + p[name]
    return y


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
    if kind == "moe" and cfg.moe_dispatch is not None:  # expert-parallel
        return cfg.moe_dispatch(
            h, p["router"], p["moe_gate"], p["moe_up"], p["moe_down"],
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    out, aux = _mlp_core(p, h, cfg, kind, shard=shard)
    return _bias(out, p, cfg, "b_down"), aux


def _mlp_core(p, h, cfg: ArchConfig, kind: str, *, shard=None,
              experts=None):
    """The MLP of the normed ``h`` without its output bias: (output, the
    MoE load-balance term or None).  A split MLP's weights are the rank's
    columns (or each expert's ``F`` slice, or under the ``experts`` split
    the rank's experts or all of them), and its output a partial sum."""
    if kind == "swiglu":
        return swiglu(h, p["w_gate"], p["w_up"], p["w_down"]), None
    if kind == "gelu":
        return gelu_mlp(h, p["w_up"], p["b_up"] if cfg.use_bias else None,
                        p["w_down"], None), None
    if kind == "relu2":
        z = h @ p["w_up"]
        if cfg.use_bias:
            z = z + p["b_up"]
        return torch.relu(z).square() @ p["w_down"], None
    if kind == "moe":
        if shard is not None and shard.batch_split():
            return shard.batch_moe(h, p, cfg, experts)
        return moe_layer_3d(h, p["router"], p["moe_gate"], p["moe_up"],
                            p["moe_down"], top_k=cfg.top_k,
                            capacity_factor=cfg.capacity_factor,
                            impl=cfg.moe_impl, ep_shard=experts,
                            seq_chunk=cfg.moe_seq_chunk, remat=cfg.remat)
    raise ValueError(kind)


def _mlp_split(p, h, cfg: ArchConfig, kind: str, shard):
    """A split MLP on the entered ``h``: (partial output, the MoE
    load-balance term with its gradient counted once over the ranks)."""
    out, aux = _mlp_core(p, h, cfg, kind, shard=shard, experts=shard.experts)
    return out, (None if aux is None else shard.split_aux(aux))


def _mamba_body(p, x, cfg: ArchConfig, *, return_state: bool = False,
                shard=None):
    """The Mamba-2 sub-block of the normed ``x``; with ``shard`` (a split
    mixer, ``x`` entered) the rank's heads and a partial output."""
    h = rms_norm(x, p["mamba_norm"], eps=cfg.norm_eps)
    if shard is not None:
        h = shard.enter(h)
    return ssdlib.mamba2_mixer(
        p, h, head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups,
        d_state=cfg.ssm_state, chunk=cfg.ssd_chunk, impl=cfg.ssd_impl,
        return_state=return_state,
        split=None if shard is None else shard.heads())


def _apply_block(p, x, cfg: ArchConfig, kind: LayerKind, *, causal: bool,
                 positions=None, enc_out=None, collect: bool = False,
                 shard=None):
    """One block; returns (x, its MoE load-balance term or None, what it
    leaves for the cache): ``{"k", "v"}`` of its attention (with
    ``{"xk", "xv"}`` of its cross-attention where it has one and
    ``enc_out`` is given), or with ``collect`` ``{"conv", "ssm"}`` of its
    Mamba mixer, or None.

    On a rank whose layers are split over ``shard.tp``, ``x`` is its
    residual stream (its block of the sequence under sequence
    parallelism); a split sub-block enters by :meth:`_Shard.enter` and
    sums its partial output by :meth:`_Shard.leave`, its output biases
    added after; the others are computed whole (:meth:`_Shard.whole_in`,
    :meth:`_Shard.whole_out`).  The k/v left for a cache have every kv
    head; a split Mamba mixer's conv tail has every channel, its SSM
    state the rank's heads."""
    split = shard is not None and shard.tp is not None
    attn = split and shard.attn_split(cfg, kind)
    mlp = split and shard.mlp_split(cfg, kind)
    mamba = split and shard.mamba_split(cfg, kind)
    whole_in = shard.whole_in if split else (lambda t: t)
    whole_out = shard.whole_out if split else (lambda t: t)
    contrib, aux = None, None

    def split_attn(h):
        """The split attention's partial output, and its k/v (of every kv
        head where a cache takes them)."""
        out, (k, v) = _attn_core(p, h, cfg, causal=causal,
                                 positions=positions, shard=shard)
        if collect:
            k, v = shard.all_heads(k, cfg), shard.all_heads(v, cfg)
        return out, {"k": k, "v": v}

    if _parallel(cfg, kind):
        # command-r: shared norm, attn & mlp in parallel
        if attn:                            # and the MLP: split together
            h = shard.enter(rms_norm(x, p["attn_norm"], eps=cfg.norm_eps))
            out, contrib = split_attn(h)
            mlp_out, aux = _mlp_split(p, h, cfg, kind.mlp, shard)
            return (x + _bias(shard.leave(out + mlp_out), p, cfg, "bo",
                              "b_down"), aux, contrib)
        xf = whole_in(x)
        attn_out, (k, v) = _attn_body(p, xf, cfg, causal=causal,
                                      positions=positions)
        mlp_out, aux = _mlp_body(p, xf, cfg, kind.mlp, norm_key="attn_norm",
                                 shard=shard)
        return (x + whole_out(attn_out) + whole_out(mlp_out), aux,
                {"k": k, "v": v})
    if kind.mixer == "attn" and attn:
        h = shard.enter(rms_norm(x, p["attn_norm"], eps=cfg.norm_eps))
        out, contrib = split_attn(h)
        x = x + _bias(shard.leave(out), p, cfg, "bo")
    elif kind.mixer == "attn":
        attn_out, (k, v) = _attn_body(p, whole_in(x), cfg, causal=causal,
                                      positions=positions)
        x = x + whole_out(attn_out)
        contrib = {"k": k, "v": v}
    elif kind.mixer == "mamba":
        # A split mixer enters and leaves as a split attention does.
        xf, out = (x, shard.leave) if mamba else (whole_in(x), whole_out)
        y = _mamba_body(p, xf, cfg, return_state=collect,
                        shard=shard if mamba else None)
        if collect:
            y, (conv_tail, ssm_state) = y
            contrib = {"conv": conv_tail, "ssm": ssm_state}
        x = x + out(y)
    if kind.cross and enc_out is not None:
        cross_out, (xk, xv) = _cross_body(p, whole_in(x), enc_out, cfg)
        x = x + whole_out(cross_out)
        contrib.update(xk=xk, xv=xv)
    if kind.mlp != "none" and mlp:
        h = shard.enter(rms_norm(x, p["mlp_norm"], eps=cfg.norm_eps))
        mlp_out, aux = _mlp_split(p, h, cfg, kind.mlp, shard)
        x = x + _bias(shard.leave(mlp_out), p, cfg, "b_down")
    elif kind.mlp != "none":
        mlp_out, aux = _mlp_body(p, whole_in(x), cfg, kind.mlp, shard=shard)
        x = x + whole_out(mlp_out)
    return x, aux, contrib


# ---------------------------------------------------------------------------
# stacks
# ---------------------------------------------------------------------------
def _period(stack: dict, key: str, n: int, shard=None, cfg=None,
            kind=None, *, decode: bool = False) -> dict:
    """Period ``n``'s parameters of position ``key`` (views, no copies):
    ``stack[key]`` maps names to stacked leaves or to their unbound
    periods.  With ``shard``, from the rank's shards
    (:meth:`_Shard.period`, for a block of ``kind``)."""
    if shard is not None:
        return shard.period(stack, key, n, cfg, kind, decode=decode)
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
        x, a, contrib = _apply_block(_period(periods, key, n, shard, cfg,
                                             kind), x,
                                     cfg, kind, causal=causal,
                                     positions=positions, enc_out=enc_out,
                                     collect=cache is not None, shard=shard)
        if a is not None:
            aux = a if aux is None else aux + a
        if cache is None or contrib is None:
            continue
        for name, val in contrib.items():
            if shard is not None:
                # A split mixer's state is its heads'; the rest is whole.
                start = shard.r * val.shape[1] if name == "ssm" \
                    and shard.mamba_split(cfg, kind) else 0
                shard.cache_write(cache[key], key, name, n, val, start)
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


def _embed_tokens(params, tokens, cfg: ArchConfig, shard=None):
    """The embedding rows of ``tokens``.  Where the vocabulary is split
    over ``shard.tp``, each rank looks up its rows (zero for the other
    tokens) and the ranks' rows are summed: all-reduced, or with
    ``to_seq`` reduce-scattered over the sequence."""
    table = params["embed"]
    if shard is None or not shard.vocab:
        return table[tokens]
    n = table.shape[0]
    local = tokens - shard.r * n
    mine = (local >= 0) & (local < n)
    return table[local.clamp(0, n - 1)] * mine[..., None].to(table.dtype)


def _embed_inputs(params, batch, cfg: ArchConfig, device, shard=None):
    """tokens (+ the patch stub) -> (x [b,s,D], loss_mask [b,s], positions
    [1,s]): patch embeddings projected by ``patch_proj`` go in front of
    the text, with a loss mask of 0; learned positions count them.  On a
    rank whose stream is split over the sequence, ``x`` is its block."""
    tokens = torch.as_tensor(batch["tokens"], device=device).long()
    x = _embed_tokens(params, tokens, cfg, shard)   # [b, s_text, D]
    patches = cfg.frontend == "patch" and "patch_embed" in batch
    # Under sequence parallelism a vocabulary-split lookup is summed
    # straight into the rank's block where nothing is added to it whole.
    to_seq = shard is not None and shard.seq and not patches \
        and not cfg.learned_pos
    if shard is not None and shard.vocab:
        x = (collectives.reduce_scatter(x, shard.mesh, shard.tp, dim=1)
             if to_seq else collectives.psum(x, shard.mesh, shard.tp))
    loss_mask = torch.ones(tokens.shape, dtype=torch.float32, device=device)
    if patches:
        patches = torch.as_tensor(batch["patch_embed"], device=device).to(
            x.dtype) @ params["patch_proj"]
        x = torch.cat([patches, x], dim=1)
        loss_mask = torch.cat([torch.zeros(patches.shape[:2],
                                           dtype=torch.float32,
                                           device=device), loss_mask], dim=1)
    if cfg.learned_pos:
        x = x + params["pos_embed"][:x.shape[1]][None]
    positions = torch.arange(loss_mask.shape[1], device=device)[None, :]
    if shard is not None and shard.seq and not (to_seq and shard.vocab):
        x = shard.whole_out(x)
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
                      shard=shard and replace(shard.at("enc", "stack"),
                                              seq=False))
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
    shards (the rest from :meth:`_Shard.tops`), and the hidden states are
    the rank's block of the sequence where its stream is split."""
    plan = layer_plan(cfg)
    x, loss_mask, positions = _embed_inputs(params, batch, cfg, device,
                                            shard)
    enc_out = None
    if cfg.enc_layers > 0:
        enc_out = _run_encoder(params, batch, cfg, device, shard)
    x, aux = _run_stack(params["stack"], x, cfg, plan, causal=True,
                        positions=positions, enc_out=enc_out, cache=cache,
                        shard=shard and shard.at("stack"))
    h = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    return h, loss_mask, aux


def _mask_vocab_pad(logits, cfg: ArchConfig, shard=None):
    """The pad columns of the vocabulary at -1e30; ``logits`` are a rank's
    slice of it where ``shard`` splits it (masked by global column)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    n = logits.shape[-1]
    lo = shard.r * n if shard is not None and shard.vocab else 0
    cols = lo + torch.arange(n, device=logits.device)
    return torch.where(cols < cfg.vocab_size, logits, -1e30)


def _seq_len(batch, cfg: ArchConfig) -> int:
    """The positions of a batch: its tokens and patches."""
    s = batch["tokens"].shape[1]
    if cfg.frontend == "patch" and "patch_embed" in batch:
        s += batch["patch_embed"].shape[1]
    return s


def _entry_shard(mesh, specs, cfg: ArchConfig, s: int):
    """:func:`_shard_of` for a call over ``s`` positions."""
    shard = _shard_of(mesh, specs, cfg)
    return shard if shard is None else shard.for_length(s)


@torch.no_grad()
def forward(params, batch, cfg: ArchConfig, *, device=None, mesh=None,
            specs=None):
    """Full-sequence f32 logits ``[b, s, vocab_size]`` (pad columns sliced
    off); ``s`` counts the patch positions too.  ``mesh``/``specs``: see
    the module's docstring; where ``specs["logits"]`` splits the
    vocabulary, the rank's slice of the padded vocabulary with pad columns
    at -1e30 (``gather_logits(...)[..., :vocab_size]`` is the whole)."""
    device = _on_device(params, device)
    shard = _entry_shard(mesh, specs, cfg, _seq_len(batch, cfg))
    if shard is not None:
        params = shard.tops(params)
    h, _, _ = _hidden(params, batch, cfg, device, shard=shard)
    if shard is not None and shard.vocab:
        return _mask_vocab_pad(_lm_head(params, shard.head_in(h), cfg), cfg,
                               shard)
    if shard is not None:
        h = shard.head_in(h)
    return _lm_head(params, h, cfg)[..., :cfg.vocab_size]


def _chunk_ce(hc, labels, mask, params, cfg: ArchConfig, shard=None):
    """Summed masked CE of one sequence chunk: ``hc [b, c, D]``, labels and
    mask ``[b, c]``.  The vocab pad is masked to -1e30 before the
    log-sum-exp, as in the reference.  Where ``shard`` splits the
    vocabulary the CE is vocab-parallel: each rank's logits are its slice,
    their maximum and sum of exponentials are reduced over the ranks, and
    the gold logit comes from the rank that holds it."""
    logits = _mask_vocab_pad(_lm_head(params, hc, cfg), cfg, shard)
    if shard is None or not shard.vocab:
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[..., None])[..., 0]
        return ((lse - gold) * mask).sum()
    mesh, tp, n = shard.mesh, shard.tp, logits.shape[-1]
    top = collectives.pmax(logits.amax(dim=-1), mesh, tp)
    lse = top + torch.log(collectives.psum(
        torch.exp(logits - top[..., None]).sum(dim=-1), mesh, tp))
    local = labels - shard.r * n
    mine = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = collectives.psum(gold * mine, mesh, tp)
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
    shard = _entry_shard(mesh, specs, cfg, _seq_len(batch, cfg))
    if shard is not None:
        params = shard.tops(params)
    h, loss_mask, aux = _hidden(params, batch, cfg, device, shard=shard)
    if shard is not None:
        h = shard.head_in(h)
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
            mask[:, c:c + chunk], params, cfg, shard, use_reentrant=False)
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
    plan = layer_plan(cfg)
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
    specs of the whole batch's cache of ``max_len``), and the logits are
    the rank's slice of the vocabulary where ``specs["logits"]`` splits
    it (:func:`gather_logits`)."""
    device = _on_device(params, device)
    b, s = batch["tokens"].shape[0], _seq_len(batch, cfg)
    shard = _entry_shard(mesh, specs, cfg, s)
    enc_len = batch["frames"].shape[1] if cfg.enc_layers > 0 else 0
    if shard is None:
        cache = _new_cache(cfg, b, max_len or s, enc_len, device)
    else:
        params = shard.tops(params)
        cache = _local_cache(cfg, b, max_len or s, enc_len, device, shard)
    h, _, _ = _hidden(params, batch, cfg, device, cache=cache, shard=shard)
    h = h[:, -1:] if shard is None else shard.last(h)
    logits = _lm_head(params, h, cfg)[:, 0]
    return _mask_vocab_pad(logits, cfg, shard), cache


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


def _decode_attn_block(p, x_t, c, n: int, cfg: ArchConfig, pos: int,
                       shard=None, *, split: bool = False, key=None):
    """x_t [b,1,D]; writes this token's k/v into slot ``pos`` of period
    ``n`` of ``c`` and attends over slots ``<= pos``.  With ``split`` (a
    split attention of ``shard``) the rank's heads: the new k/v of every kv
    head go into the cache, and the output projection is a partial sum
    without its bias.

    With ``key``, ``c`` is the rank's own cache of period position ``key``:
    the new k/v are written by the rank that holds slot ``pos``, and where
    the slots are split over ``shard.tp`` each rank attends over its own
    (the query gathered to every head) and the ranks' partial softmaxes
    are combined (flash-decode, :meth:`_Shard.combine`).  Else ``c`` is
    the whole cache, and a split attention reads its kv heads of it."""
    h = rms_norm(x_t, p["attn_norm"], eps=cfg.norm_eps)
    q, k, v = _project_qkv(p, h, cfg)
    if cfg.rope:
        posb = torch.full((x_t.shape[0], 1), pos, device=x_t.device)
        q = rope(q, posb, theta=cfg.rope_theta)
        k = rope(k, posb, theta=cfg.rope_theta)
    if split:
        k, v = shard.all_heads(k, cfg), shard.all_heads(v, cfg)
    kc, vc = c["k"][n], c["v"][n]
    if key is None:
        kc[:, pos:pos + 1] = k
        vc[:, pos:pos + 1] = v
    else:
        shard.cache_write(c, key, "k", n, k, start=pos)
        shard.cache_write(c, key, "v", n, v, start=pos)
    if key is not None and shard.slots_split(key, "k"):
        if split:
            q = collectives.all_gather(q, shard.mesh, shard.tp, dim=2)
        lo = shard.r * kc.shape[1]
        mask = (lo + torch.arange(kc.shape[1], device=x_t.device)
                <= pos).float()
        attn = shard.combine(decode_attention_partial(q, kc, vc, mask),
                             own_heads=split).to(q.dtype)
    else:
        if split:
            kc, vc = shard.kv_heads(kc, cfg), shard.kv_heads(vc, cfg)
        mask = (torch.arange(kc.shape[1], device=x_t.device) <= pos).float()
        attn = decode_attention(q, kc, vc, mask)
    return _attn_out(p, attn, cfg, bias=not split)


def _decode_cross_block(p, x_t, c, n: int, cfg: ArchConfig, shard=None,
                        key=None):
    """x_t [b,1,D]; attends to period ``n``'s cached encoder k/v: with
    ``key`` (see :func:`_decode_attn_block`) where the frames are split
    over ``shard.tp``, over the rank's frames and combined."""
    q = _cross_query(p, x_t, cfg)
    if key is not None and shard.slots_split(key, "xk"):
        part = decode_attention_partial(q, c["xk"][n], c["xv"][n], None)
        attn = shard.combine(part, own_heads=False).to(q.dtype)
    else:
        attn = decode_attention(q, c["xk"][n], c["xv"][n], None)
    return _attn_out(p, attn, cfg, prefix="x")


def _decode_mamba_block(p, x_t, c, n: int, cfg: ArchConfig, shard=None):
    """x_t [b,1,D]; advances period ``n``'s conv window and SSM state in
    ``c`` by this token, in place.  With ``shard`` (a split mixer, ``c``
    the rank's own cache: its block of the conv channels and its heads'
    states) the rank's heads, and a partial output."""
    h = rms_norm(x_t, p["mamba_norm"], eps=cfg.norm_eps)
    conv, ssm = c["conv"][n], c["ssm"][n]
    split = None if shard is None else shard.heads()
    y, mc = ssdlib.mamba2_decode_step(
        p, h[:, 0], ssdlib.MambaCache(conv=conv, ssm=ssm),
        head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups,
        d_state=cfg.ssm_state, split=split)
    conv.copy_(mc.conv)
    ssm.copy_(mc.ssm)
    return y[:, None, :]


@torch.no_grad()
def decode_step(params, cache, tokens, pos, cfg: ArchConfig, *, device=None,
                mesh=None, specs=None):
    """One-token decode.  tokens ``[b, 1]``; ``pos`` the slot of the new
    token (an int).  Returns (logits ``[b, padded_vocab]`` f32 with pad
    columns at -1e30, cache) — the same cache object, updated in place.
    MoE layers run dropless here: ``b`` tokens at ``capacity_factor =
    n_experts / top_k`` give every expert room for all of them.  On a
    mesh, ``cache`` is the rank's shard from :func:`prefill`, and the
    logits are as :func:`prefill`'s."""
    device = _on_device(params, device)
    plan = layer_plan(cfg)
    if cfg.moe:
        cfg = replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    shard = _entry_shard(mesh, specs, cfg, 1)
    if shard is not None:
        params = shard.tops(params)
    pos = int(pos)
    tokens = torch.as_tensor(tokens, device=device).long()
    x = _embed_tokens(params, tokens, cfg, shard)   # [b,1,D]
    if shard is not None and shard.vocab:
        x = collectives.psum(x, shard.mesh, shard.tp)
    if cfg.learned_pos:
        x = x + params["pos_embed"][pos:pos + 1][None]
    stack = params["stack"]
    sh = shard and shard.at("stack")
    for n in range(cfg.n_layers // len(plan)):
        for i, kind in enumerate(plan):
            key = f"p{i}"
            p = _period(stack, key, n, sh, cfg, kind, decode=True)
            c, m, at = cache.get(key), n, None
            if sh is not None and c is not None:
                if sh.in_place(cfg, kind, key):
                    at = key
                else:
                    # The period's cache gathered whole, written back
                    # after.
                    c = {name: sh.cache_read(c, key, name, n)[None]
                         for name in c}
                    m = 0
            x = _decode_block(p, x, c, m, cfg, pos, kind, sh, at)
            if at is None and sh is not None and c is not None:
                _write_back(sh, cache[key], key, n, c, kind, pos)
    h = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    logits = _lm_head(params, h, cfg)[:, 0]
    return _mask_vocab_pad(logits, cfg, shard), cache


def _decode_block(p, x, c, n: int, cfg: ArchConfig, pos: int,
                  kind: LayerKind, shard=None, key=None):
    """One block of a decode step.  On a rank whose layers are split over
    ``shard.tp`` (one position: Megatron without sequence parallelism)
    each split product is all-reduced; the other sub-blocks run whole.
    ``key``: ``c`` is the rank's own cache of that period position (see
    :func:`_decode_attn_block`), else the whole cache."""
    split = shard is not None and shard.tp is not None
    attn = split and shard.attn_split(cfg, kind)
    mlp = split and shard.mlp_split(cfg, kind)
    if _parallel(cfg, kind):
        out = _decode_attn_block(p, x, c, n, cfg, pos, shard, split=attn,
                                 key=key)
        if not attn:
            return x + out + _mlp_body(p, x, cfg, kind.mlp,
                                       norm_key="attn_norm")[0]
        h = rms_norm(x, p["attn_norm"], eps=cfg.norm_eps)
        out = out + _mlp_split(p, h, cfg, kind.mlp, shard)[0]
        return x + _bias(shard.leave(out), p, cfg, "bo", "b_down")
    if kind.mixer == "attn":
        out = _decode_attn_block(p, x, c, n, cfg, pos, shard, split=attn,
                                 key=key)
        x = x + (_bias(shard.leave(out), p, cfg, "bo") if attn else out)
    elif kind.mixer == "mamba" and key is not None:    # a split mixer
        x = x + shard.leave(_decode_mamba_block(p, x, c, n, cfg, shard))
    elif kind.mixer == "mamba":
        x = x + _decode_mamba_block(p, x, c, n, cfg)
    if kind.cross:
        x = x + _decode_cross_block(p, x, c, n, cfg, shard, key)
    if kind.mlp != "none" and mlp:
        h = rms_norm(x, p["mlp_norm"], eps=cfg.norm_eps)
        x = x + _bias(shard.leave(_mlp_split(p, h, cfg, kind.mlp, shard)[0]),
                      p, cfg, "b_down")
    elif kind.mlp != "none":
        x = x + _mlp_body(p, x, cfg, kind.mlp)[0]
    return x


def _write_back(shard: _Shard, local: dict, key: str, n: int, c: dict,
                kind: LayerKind, pos: int) -> None:
    """What a decode step changed in period ``n``'s gathered cache ``c``,
    into the rank's slices ``local`` (its cache of position ``key``): the
    new token's k/v slot, the Mamba conv window and SSM state."""
    if kind.mixer == "attn":
        for name in ("k", "v"):
            shard.cache_write(local, key, name, n, c[name][0][:, pos:pos + 1],
                              start=pos)
    elif kind.mixer == "mamba":
        for name in ("conv", "ssm"):
            shard.cache_write(local, key, name, n, c[name][0])
