"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 48L d2048, 64e top-6.

[hf:moonshotai/Moonlight-16B-A3B].  Assignment specifies GQA kv=16 (MHA).
2 shared experts + leading dense layer follow the HF config; expert width 1408.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840, head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
    first_dense_layers=1, d_ff_dense=11264,
    rope_theta=50000.0,
)
