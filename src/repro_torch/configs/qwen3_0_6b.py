"""qwen3-0.6b — dense, 28L d1024 16H (GQA kv=8) d_ff=3072 vocab=151936.

qk_norm + GQA; head_dim fixed at 128 (Qwen3 decouples head_dim from
d_model/n_heads).  [hf:Qwen/Qwen3-8B family; hf-verified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    source="hf:Qwen/Qwen3-0.6B",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    qk_norm=True,
    use_bias=False,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    mlp_act="swiglu",
)
