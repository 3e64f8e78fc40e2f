"""minitron-4b — dense, 32L d3072 24H (GQA kv=8) d_ff=9216 vocab=256000.

Pruned Nemotron; squared-ReLU (non-gated) MLP as in the Nemotron family.
[arXiv:2407.14679; hf-verified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    source="arXiv:2407.14679",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256_000,
    qk_norm=False,
    use_bias=False,
    tie_embeddings=False,   # 4.19B total with untied embed/head
    rope_theta=10_000.0,
    mlp_act="relu2",
)
