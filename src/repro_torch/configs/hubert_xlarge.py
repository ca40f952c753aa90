"""hubert-xlarge [audio] — encoder-only 48L d1280 16H, per-frame classification.

[arXiv:2106.07447; unverified].  The conv feature extractor is a STUB —
input_specs() provides precomputed frame embeddings (frame_dim 512).  The
encoder uses RoPE in place of hubert's conv positional embedding (DESIGN.md).
No decode shapes: encoder-only.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab=504, head_dim=80,
    ffn_kind="gelu", ffn_bias=True, norm_kind="layer",
    causal=False, frame_dim=512,
)
