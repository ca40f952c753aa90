"""qwen3-4b [dense] — 36L d2560 32H GQA kv=8, qk_norm, head_dim 128. [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1000000.0,
)
