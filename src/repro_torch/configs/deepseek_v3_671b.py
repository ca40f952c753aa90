"""deepseek-v3-671b [moe] — 61L d7168 128H MLA, 1 shared + 256 routed top-8, MTP.

[arXiv:2412.19437; hf].  d_ff=2048 is the routed-expert width; the leading 3
dense layers use the published 18432 dense width.  MLA ranks are the published
q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab=129280, head_dim=128,
    attn_kind="mla",
    q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=256, top_k=8, n_shared_experts=1, d_ff_expert=2048,
    first_dense_layers=3, d_ff_dense=18432,
    mtp=True,
    rope_theta=10000.0,
)
