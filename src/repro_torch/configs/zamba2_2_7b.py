"""zamba2-2.7b [hybrid] — 54 Mamba2 layers + weight-shared attention block.

[arXiv:2411.15242; hf].  The shared MHA+FFN block (32 heads, d_ff 10240) is
applied after every 6 mamba layers (9 applications, one weight set) —
zamba2's per-invocation LoRA deltas are not modelled (DESIGN.md).
ssm_state=64 per assignment.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, hybrid_period=6,
)
