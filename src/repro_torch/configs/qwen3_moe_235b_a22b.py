"""qwen3-moe-235b-a22b — MoE, 94L d4096 64H (GQA kv=4), per-expert
d_ff=1536, 128 experts top-8, vocab=151936.  qk_norm; every layer MoE.
[hf:Qwen/Qwen3-235B-A22B family; hf-verified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-235B-A22B",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,                 # all layers routed
    vocab_size=151_936,
    qk_norm=True,
    use_bias=False,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    moe=True,
    n_experts=128,
    top_k=8,
    moe_d_ff=1536,
    moe_every=1,
    moe_impl="scatter",     # one-hot dispatch einsums are infeasible at 128e
    remat=True,
)
