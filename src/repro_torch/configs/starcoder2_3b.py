"""starcoder2-3b [dense] — 30L d3072 24H GQA kv=2, RoPE, GELU MLP + bias, LayerNorm.

[arXiv:2402.19173; hf].  (4096-token sliding window is a no-op at these shapes
and is not modelled — noted in DESIGN.md.)
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab=49152, head_dim=128,
    ffn_kind="gelu", ffn_bias=True, norm_kind="layer", qkv_bias=True,
    rope_theta=999999.0,
)
