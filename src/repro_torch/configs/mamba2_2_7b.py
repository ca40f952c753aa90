"""mamba2-2.7b [ssm] — 64L d2560 attention-free SSD. [arXiv:2405.21060; unverified].

state=128, headdim=64, expand=2 (d_inner 5120, 80 heads, 1 group).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    attn_kind="none",
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
)
