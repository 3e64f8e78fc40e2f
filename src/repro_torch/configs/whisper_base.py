"""whisper-base — audio enc-dec, 6L(+6L enc) d512 8H (MHA) d_ff=2048
vocab=51865.  Conv frontend is a **stub**: ``input_specs()`` feeds
precomputed frame embeddings [b, 1500, 512].  GELU MLP, biases, learned
decoder positions, no RoPE.  Decode shapes run the assigned KV length on the
backbone (shape stress test per DESIGN.md).  [arXiv:2212.04356; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=6,
    enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,           # MHA
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    qk_norm=False,
    use_bias=True,
    tie_embeddings=True,    # whisper ties decoder embed/proj
    rope=False,
    learned_pos=True,
    max_position=4096,      # covers train_4k; the planner widens it per shape
    mlp_act="gelu",
    frontend="audio",
    frontend_len=1500,      # 30 s of post-conv frames
)
