"""command-r-plus-104b — dense, 64L d12288 96H (GQA kv=8) d_ff=33792
vocab=256000.  No-bias, parallel attention∥MLP blocks (Cohere style), tied
embeddings.  [hf:CohereForAI/c4ai-command-r-v01; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-plus",
    n_layers=64,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33_792,
    vocab_size=256_000,
    qk_norm=False,
    use_bias=False,
    tie_embeddings=True,
    parallel_block=True,
    rope_theta=75_000_000.0,
    mlp_act="swiglu",
    remat=True,
)
