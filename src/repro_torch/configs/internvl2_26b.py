"""internvl2-26b — VLM: InternLM2-20B LM backbone (48L d6144 48H GQA kv=8
d_ff=16384 vocab=92553) + InternViT-6B frontend **stub**.

Per the assignment, the modality frontend is a stub: ``input_specs()`` feeds
precomputed patch embeddings of the ViT width (3200) which a learned
projection maps into the LM.  [arXiv:2404.16821; hf-verified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=92_553,
    qk_norm=False,
    use_bias=False,
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    mlp_act="swiglu",
    frontend="patch",
    frontend_len=256,       # one ViT tile = 256 patch embeddings
    frontend_dim=3200,      # InternViT-6B width
    remat=True,
)
