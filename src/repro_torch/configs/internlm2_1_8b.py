"""internlm2-1.8b — dense, 24L d2048 16H (GQA kv=8) d_ff=8192 vocab=92544.

LLaMA-style GQA decoder.  [arXiv:2403.17297; hf-verified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    source="arXiv:2403.17297",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_544,
    qk_norm=False,
    use_bias=False,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    mlp_act="swiglu",
)
