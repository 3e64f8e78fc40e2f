"""mamba2-2.7b — attention-free SSM (state-space duality), 64L d2560
ssm_state=128 vocab=50280.  d_inner = 2*d = 5120, head_dim 64 → 80 heads,
1 B/C group; pure Mamba-2 blocks (no MLP).  Sub-quadratic → runs long_500k.
[arXiv:2405.21060; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_conv=4,
)
