"""Model assembly for the serving slice: decoder LMs and Mamba2 stacks.

Port of :mod:`repro.models.build` for two families:

  dense — decoder transformer, GQA attention and a dense FFN (one segment of
      ``"self"`` blocks; ``prefill_last_only`` honoured).
  ssm — Mamba2 (SSD) stack, attention-free.

``repro``'s stacked parameters with a leading layer axis become an
``nn.ModuleList`` with one ``nn.ModuleDict`` per layer, under the same
names (``segments/seg0/<l>/attn/wq``, ``segments/mamba/<l>/mamba/in_proj``),
so :func:`repro_torch.models.convert.load_jax_params` carries a JAX parameter
tree across by name.  A model exposes ``repro``'s serving surface:
``forward(batch)``, ``init_cache(batch, max_len)`` and ``decode_step(cache,
tokens, pos) -> (logits, cache)``; the cache is updated in place, which
stands in for the JAX package's donated cache buffers.

Families ``moe``, ``vlm``, ``audio`` and ``hybrid``, MLA attention and the
int8 KV cache raise ``NotImplementedError`` (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (GQAConfig, KVCache, gqa_attend, gqa_decode,
                                          init_gqa, init_gqa_cache)
from repro_torch.models.common import dense_init, embed_init, layer_norm, params, rms_norm
from repro_torch.models.ffn import dense_ffn, init_dense_ffn
from repro_torch.models.mamba import (MambaCache, SSMConfig, init_mamba2,
                                      init_mamba_cache, mamba2_decode, mamba2_forward)

# what this slice does not build yet, each with its place in ROADMAP Queue 1
# item 11's deferred order
DEFERRED_FAMILIES = {
    "hybrid": "deferred item 1 (zamba2's shared attention block)",
    "moe": "deferred item 3 (MoE)",
    "vlm": "deferred item 3 (cross-attention)",
    "audio": "deferred item 3 (the audio encoder)",
}


# ---------------------------------------------------------------------------
# config plumbing
# ---------------------------------------------------------------------------


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _cache_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.float32 if cfg.dtype == "float32" else torch.bfloat16


def _gqa_cfg(cfg: ArchConfig) -> GQAConfig:
    return GQAConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_actual,
        qk_norm=cfg.qk_norm,
        qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        causal=cfg.causal,
        attention_impl=cfg.attention_impl,
        block_k=cfg.block_k,
    )


def _ssm_cfg(cfg: ArchConfig) -> SSMConfig:
    return SSMConfig(
        d_model=cfg.d_model,
        d_state=cfg.ssm_state,
        head_dim=cfg.ssm_head_dim,
        expand=cfg.ssm_expand,
        n_groups=cfg.ssm_groups,
        conv_kernel=4,
        chunk=cfg.ssm_chunk,
        ssd_impl=cfg.ssd_impl,
    )


def _init_norm(cfg: ArchConfig, dtype, device) -> nn.ParameterDict:
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm_kind == "layer":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return params(p)


def _norm(x: torch.Tensor, p, cfg: ArchConfig) -> torch.Tensor:
    if cfg.norm_kind == "layer":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


class _LM(nn.Module):
    """Embedding, final norm and head, shared by both families."""

    def __init__(self, cfg: ArchConfig, device: torch.device, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.device = device
        dtype = _dtype(cfg)
        kw = dict(dtype=dtype, device=device, generator=generator)
        V, D = cfg.vocab, cfg.d_model
        self.embed = params({"table": embed_init((V, D), **kw)})
        self.final_norm = _init_norm(cfg, dtype, device)
        self.head = params({"w": dense_init((D, V), in_axis=0, **kw)})

    def _embed(self, tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, device=self.device)
        return nn.functional.embedding(tokens.long(), self.embed["table"])

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return _norm(x, self.final_norm, self.cfg) @ self.head["w"]


# ---------------------------------------------------------------------------
# decoder LM (dense)
# ---------------------------------------------------------------------------


class DecoderLM(_LM):
    def __init__(self, cfg: ArchConfig, device: torch.device, generator: torch.Generator):
        super().__init__(cfg, device, generator)
        self.gqa = _gqa_cfg(cfg)
        dtype = _dtype(cfg)
        kw = dict(dtype=dtype, device=device, generator=generator)

        def block() -> nn.ModuleDict:
            return nn.ModuleDict({
                "norm1": _init_norm(cfg, dtype, device),
                "norm2": _init_norm(cfg, dtype, device),
                "attn": init_gqa(self.gqa, **kw),
                "ffn": init_dense_ffn(cfg.d_model, cfg.d_ff, kind=cfg.ffn_kind,
                                      bias=cfg.ffn_bias, **kw),
            })

        self.segments = nn.ModuleDict(
            {"seg0": nn.ModuleList([block() for _ in range(cfg.n_layers)])})

    def forward(self, batch) -> torch.Tensor:
        """Prefill: logits (B, T, V), or (B, 1, V) under ``prefill_last_only``."""
        cfg = self.cfg
        x = self._embed(batch["tokens"])
        for blk in self.segments["seg0"]:
            x = x + gqa_attend(blk["attn"], _norm(x, blk["norm1"], cfg), self.gqa)
            x = x + dense_ffn(blk["ffn"], _norm(x, blk["norm2"], cfg), kind=cfg.ffn_kind)
        if cfg.prefill_last_only:
            x = x[:, -1:]                 # serving: only next-token logits
        return self._logits(x)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, List[KVCache]]:
        return {"seg0": [init_gqa_cache(self.gqa, batch, max_len, _cache_dtype(self.cfg),
                                        device=self.device)
                         for _ in range(self.cfg.n_layers)]}

    def decode_step(self, cache, tokens, pos: int):
        cfg = self.cfg
        x = self._embed(tokens)
        for blk, c in zip(self.segments["seg0"], cache["seg0"]):
            _, a = gqa_decode(blk["attn"], c, _norm(x, blk["norm1"], cfg), self.gqa, pos)
            x = x + a
            x = x + dense_ffn(blk["ffn"], _norm(x, blk["norm2"], cfg), kind=cfg.ffn_kind)
        return self._logits(x), cache


# ---------------------------------------------------------------------------
# SSM (mamba2)
# ---------------------------------------------------------------------------


class SSMLM(_LM):
    def __init__(self, cfg: ArchConfig, device: torch.device, generator: torch.Generator):
        super().__init__(cfg, device, generator)
        self.ssm = _ssm_cfg(cfg)
        dtype = _dtype(cfg)
        self.segments = nn.ModuleDict({"mamba": nn.ModuleList([
            nn.ModuleDict({"norm": _init_norm(cfg, dtype, device),
                           "mamba": init_mamba2(self.ssm, dtype=dtype, device=device,
                                                generator=generator)})
            for _ in range(cfg.n_layers)])})

    def forward(self, batch) -> torch.Tensor:
        x = self._embed(batch["tokens"])
        for blk in self.segments["mamba"]:
            x = x + mamba2_forward(blk["mamba"], _norm(x, blk["norm"], self.cfg), self.ssm)
        return self._logits(x)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, List[MambaCache]]:
        return {"mamba": [init_mamba_cache(self.ssm, batch, _dtype(self.cfg), device=self.device)
                          for _ in range(self.cfg.n_layers)]}

    def decode_step(self, cache, tokens, pos: int):
        x = self._embed(tokens)
        for blk, c in zip(self.segments["mamba"], cache["mamba"]):
            _, y = mamba2_decode(blk["mamba"], c, _norm(x, blk["norm"], self.cfg), self.ssm)
            x = x + y
        return self._logits(x), cache


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def build_model(cfg: ArchConfig, device=None,
                generator: Optional[torch.Generator] = None) -> _LM:
    """The model of ``cfg`` on ``device`` (``None``: the card), its weights
    drawn from ``generator`` (default: seed 0 on that device)."""
    if cfg.family in DEFERRED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (ROADMAP "
                                  f"Queue 1 item 11, {DEFERRED_FAMILIES[cfg.family]})")
    if cfg.attn_kind == "mla":
        raise NotImplementedError("MLA attention is not ported yet (ROADMAP Queue 1 "
                                  "item 11, deferred item 2)")
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("the int8 KV cache is not ported yet (ROADMAP Queue 1 "
                                  "item 11, deferred item 4)")
    if cfg.family not in ("dense", "ssm"):
        raise ValueError(f"unknown family {cfg.family}")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    return (DecoderLM if cfg.family == "dense" else SSMLM)(cfg, device, generator)
