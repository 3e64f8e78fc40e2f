"""granite-moe-3b-a800m — MoE, 32L d1536 24H (GQA kv=8), per-expert
d_ff=512, 40 experts top-8, vocab=49155.  Every layer MoE, tied embeddings.
[hf:ibm-granite/granite-3.0 family; hf-verified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,                 # no dense MLP — every layer routed
    vocab_size=49_155,
    qk_norm=False,
    use_bias=False,
    tie_embeddings=True,
    rope_theta=10_000.0,
    moe=True,
    n_experts=40,
    top_k=8,
    moe_d_ff=512,
    moe_every=1,
)
