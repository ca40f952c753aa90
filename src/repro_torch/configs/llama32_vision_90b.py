"""llama-3.2-vision-90b [vlm] — 100L d8192 64H GQA kv=8; cross-attn image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified].  Backbone only: the vision
frontend is a STUB — input_specs() provides precomputed patch embeddings
(vision_dim 7680, the published projector width); a cross-attention layer
closes every 5-layer superblock (20 x [4 self + 1 cross] = 100 layers).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    cross_attn_period=5, vision_tokens=1601, vision_dim=7680,
    rope_theta=500000.0,
)
