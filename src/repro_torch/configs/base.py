"""Architecture + shape configuration schema — a copy of
``repro/configs/base.py`` (dataclasses only), field for field, so a config
means the same in both packages and ``to_dict()`` compares equal.

One ``ArchConfig`` per assigned architecture (exact hyperparameters from the
assignment table) plus the paper's own four FL-task models.  ``ShapeConfig``
describes the assigned input-shape cells; ``reduced()`` produces the smoke-
test scale of the same family.

The execution knobs keep the reference's values: ``attn_impl="pallas"``
selects the port's hand-written CUDA flash-attention kernel (K4) where it
selects the Pallas kernel in the reference.  The sharding hooks stay
identities: the port has no JAX mesh to shard over.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "FLPlan"]


@dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str                 # dense | moe | vlm | hybrid | audio | ssm
    source: str = ""

    # transformer backbone
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0           # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 0
    qk_norm: bool = False
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6

    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0           # per-expert hidden dim
    moe_every: int = 1          # apply MoE on layers where l % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # hybrid / ssm
    attn_every: int = 1         # jamba: attention on layers where l % attn_every == attn_offset
    attn_offset: int = 0
    ssm_state: int = 0          # mamba d_state
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4

    # encoder-decoder (audio) / multimodal
    enc_layers: int = 0         # >0 -> encoder-decoder
    frontend: str = ""          # 'audio' | 'patch' | '' — stubbed modality input
    frontend_len: int = 0       # frames/patches per example fed as embeddings
    frontend_dim: int = 0       # stub embedding dim (e.g. ViT width); 0 -> d_model

    # block structure details
    mlp_act: str = "swiglu"     # 'swiglu' | 'relu2' | 'gelu'
    parallel_block: bool = False  # command-r style attn ∥ mlp with shared norm
    rope: bool = True
    learned_pos: bool = False   # whisper decoder absolute positions
    max_position: int = 0       # learned-pos table size (set by the planner)
    ssm_groups: int = 1         # B/C groups (mamba2 'ngroups')

    # execution knobs (the §Perf hillclimbing surface; swapped via replace())
    attn_impl: str = "dense"    # 'dense' | 'chunked' | 'pallas' (in the
                                # port 'pallas' = the CUDA kernel K4)
    attn_q_chunk: int = 512
    attn_repeat_kv: bool = False  # repeat kv to Hq (even TP head sharding)
    moe_impl: str = "einsum"    # 'einsum' | 'scatter'
    moe_seq_chunk: int = 0      # >0: dispatch in seq blocks (caps buffers)
    ssd_impl: str = "chunked"   # 'chunked' | 'recurrent' | 'pallas' (in
                                # the port 'pallas' = the CUDA kernel K5)
    ssd_chunk: int = 128
    remat: bool = False         # jax.checkpoint around each period body
    loss_chunk: int = 2048      # seq-chunked CE (0 = single shot)
    moe_aux_weight: float = 0.01

    # numerics
    dtype: str = "bfloat16"

    # sharding hooks injected by the launcher (identity by default); excluded
    # from to_dict().  These are with_sharding_constraint partials.
    act_shard: object = staticmethod(lambda x: x)
    act_shard_logits: object = staticmethod(lambda x: x)
    act_shard_moe: object = None   # expert-buffer constraint ([E, C, ...])
    moe_dispatch: object = None    # manual EP dispatch (shard_map; §Perf B3)
    # Megatron-SP gather point: inside each block, after the norm, the
    # sequence dim is gathered (batch stays sharded) so projections contract
    # against TP-sharded weights without XLA re-gathering the weights.
    act_gather: object = staticmethod(lambda x: x)

    # --- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:   # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_attention_layer(self, l: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_every <= 1:
            return True
        return l % self.attn_every == self.attn_offset

    def is_moe_layer(self, l: int) -> bool:
        if not self.moe:
            return False
        return l % self.moe_every == self.moe_offset

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM / hybrid / linear-attn.)"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have decoders (whisper is enc-dec)

    @property
    def resolved_frontend_dim(self) -> int:
        return self.frontend_dim or self.d_model

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a 256 multiple so embed/lm_head shard evenly
        over a 16-way TP axis with 128-lane alignment (Megatron-style
        padding; pad columns are masked out of the loss)."""
        return (self.vocab_size + 255) // 256 * 256

    def encoder_cfg(self) -> "ArchConfig":
        """The encoder stack of an enc-dec arch as a standalone config:
        full attention (non-causal applied by the caller), dense MLP, no MoE,
        no cross, no ssm."""
        return replace(self, n_layers=self.enc_layers, enc_layers=0,
                       attn_every=1, moe=False, rope=False, learned_pos=False,
                       parallel_block=False)

    def reduced(self) -> "ArchConfig":
        """Same-family smoke-test scale: small layers/width/experts/vocab."""
        kw = dict(
            n_layers=min(self.n_layers, 4) or 2,
            d_model=min(self.d_model, 64) or 64,
            d_ff=min(self.d_ff, 128) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 256) or 256,
            dtype="float32",
        )
        if self.n_heads:
            kw["n_heads"] = min(self.n_heads, 4)
            kw["n_kv_heads"] = min(self.n_kv_heads or self.n_heads, 2)
            kw["head_dim"] = 16
        if self.moe:
            kw["n_experts"] = min(self.n_experts, 4)
            kw["top_k"] = min(self.top_k, 2)
            kw["moe_d_ff"] = min(self.moe_d_ff, 64)
        if self.ssm_state:
            kw["ssm_state"] = min(self.ssm_state, 16)
            kw["ssm_head_dim"] = 16
        if self.enc_layers:
            kw["enc_layers"] = min(self.enc_layers, 2)
        if self.attn_every > 1:
            period = self.attn_every
            if self.moe and self.moe_every > 1:
                import math as _math
                period = period * self.moe_every // _math.gcd(
                    period, self.moe_every)
            kw["n_layers"] = max(kw["n_layers"], period)
        if self.frontend:
            kw["frontend_len"] = min(self.frontend_len or 16, 16)
            if self.frontend_dim:
                kw["frontend_dim"] = min(self.frontend_dim, 32)
        if self.learned_pos:
            kw["max_position"] = 128
        kw["loss_chunk"] = 0
        kw["remat"] = False
        return replace(self, **kw)

    def to_dict(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if callable(v):
                continue
            d[f.name] = v
        return d


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # 'train' | 'prefill' | 'decode'

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


@dataclass(frozen=True)
class FLPlan:
    """How a federated round maps onto the mesh for one (arch × shape).

    worker_axes: mesh axes that index FL workers (W = their product).
    lanes (P), steps (S), per-step batch (b): W*P*S*b == global_batch.
    batch_axes: mesh axes the per-step batch dim is sharded over.
    """

    worker_axes: tuple = ("data",)
    lanes: int = 1
    steps: int = 2
    batch: int = 8
    batch_axes: tuple = ()
