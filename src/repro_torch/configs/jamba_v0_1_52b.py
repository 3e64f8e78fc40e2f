"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, 32L d4096 32H
(GQA kv=8) d_ff=14336, MoE 16e top-2 on every 2nd layer, vocab=65536.

Period = lcm(attn_every=8, moe_every=2) = 8: one attention layer per 8
(at offset 4, as in the Jamba block), MoE on odd offsets.  The paper's
Jamba uses Mamba-1 mixers; we use the Mamba-2 SSD mixer as the TPU-idiomatic
family representative (noted in DESIGN.md §Arch-applicability).
[arXiv:2403.19887; hf-verified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    qk_norm=False,
    use_bias=False,
    tie_embeddings=False,
    rope=False,             # Jamba uses no positional encoding
    moe=True,
    n_experts=16,
    top_k=2,
    moe_d_ff=14_336,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    moe_impl="scatter",
    remat=True,
)
