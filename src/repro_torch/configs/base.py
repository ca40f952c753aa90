"""Architecture / shape / mesh configuration schema.

Every assigned architecture gets a ``configs/<id>.py`` exporting ``CONFIG``
(the exact published config) — the registry in ``configs/__init__`` resolves
``--arch <id>`` to it.  ``smoke_config`` derives the reduced same-family
variant used by CPU tests; the full configs run on the card.

A copy of :mod:`repro.configs.base` (the port imports nothing of ``repro``);
the fields keep their names and defaults, so one config means the same model
in both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None       # default: d_model // n_heads

    # attention flavour
    attn_kind: str = "gqa"               # gqa | mla | none
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_kind: str = "rms"               # rms | layer
    causal: bool = True

    # ffn flavour
    ffn_kind: str = "swiglu"             # swiglu | gelu
    ffn_bias: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    d_ff_dense: int = 0                  # width of the leading dense layers
    capacity_factor: float = 1.25
    moe_impl: str = "gather"             # gather | dense
    aux_loss_weight: float = 0.01

    # MLA (deepseek)
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 128
    ssd_impl: str = "chunked"            # chunked | pallas

    # hybrid (zamba2): shared attention block after every `hybrid_period` mamba layers
    hybrid_period: int = 0

    # vision (llama-3.2-vision): cross-attn layer closing every `cross_attn_period`-layer superblock
    cross_attn_period: int = 0
    vision_tokens: int = 1601
    vision_dim: int = 0                  # 0 → d_model (stub patch embeddings)

    # audio (hubert): stub frame embeddings
    frame_dim: int = 0

    # MTP (deepseek multi-token prediction)
    mtp: bool = False
    mtp_weight: float = 0.3

    # implementation switches
    attention_impl: str = "blocked"      # blocked | naive | pallas
    block_k: int = 512
    remat: str = "none"                  # none | full | dots (selective)
    dtype: str = "float32"
    z_loss: float = 0.0
    scan_layers: bool = True

    # ---- beyond-paper performance knobs (§Perf hillclimb) -------------------
    grad_reduce_dtype: str = ""          # "bfloat16" → cast grads before optimizer
                                         # (bf16 DP collectives, fp32 moments kept)
    bwd_bf16_boundary: bool = False      # cast residual-stream cotangents to bf16
                                         # (halves TP backward all-reduce bytes)
    chunked_ce: bool = False             # streaming CE over vocab chunks — never
                                         # materialises the (B,T,V) fp32 logits
    ce_chunk: int = 8192
    seq_shard: bool = False              # Megatron-SP: shard activations over the
                                         # model axis between blocks
    prefill_last_only: bool = False      # serving prefill emits only the last
                                         # position's logits (T× less head work)
    kv_cache_dtype: str = ""             # "int8" → quantized decode KV cache
                                         # (per-token-head scales, half the reads)
    batch_axes: tuple = ("data",)        # set by build_cell from the mesh

    @property
    def head_dim_actual(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_encoder_only(self) -> bool:
        return self.family == "audio"

    @property
    def has_decode(self) -> bool:
        return not self.is_encoder_only

    @property
    def subquadratic(self) -> bool:
        """Whether long_500k applies (SSM/hybrid archs only, per assignment)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_runnable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch × shape) cell."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only: no autoregressive decode step exists"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k context needs sub-quadratic attention"
    return True, ""


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (one step, no NaNs)."""
    kw = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab=256,
        dtype="float32",
        remat="none",
        block_k=64,
    )
    if cfg.family == "moe":
        kw.update(n_experts=8, top_k=2, d_ff_expert=64,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_dense_layers=min(cfg.first_dense_layers, 1),
                  d_ff_dense=128, moe_impl=cfg.moe_impl)
    if cfg.attn_kind == "mla":
        kw.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                  qk_rope_dim=8, v_head_dim=16)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=8, ssm_expand=2, ssm_chunk=8)
    if cfg.family == "hybrid":
        kw.update(n_layers=4, hybrid_period=2, n_kv_heads=4)  # MHA shared block
    if cfg.family == "vlm":
        kw.update(n_layers=4, cross_attn_period=2, vision_tokens=8, vision_dim=32)
    if cfg.family == "audio":
        kw.update(frame_dim=32, vocab=16)
    if cfg.mtp:
        kw.update(mtp=True)
    return cfg.replace(**kw)
