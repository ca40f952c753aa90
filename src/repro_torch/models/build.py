"""Model assembly: decoder LMs and Mamba2 stacks, for serving and training.

Port of :mod:`repro.models.build` for two families:

  dense — decoder transformer, GQA attention and a dense FFN (one segment of
      ``"self"`` blocks; ``prefill_last_only`` honoured).
  ssm — Mamba2 (SSD) stack, attention-free.

``repro``'s stacked parameters with a leading layer axis become an
``nn.ModuleList`` with one ``nn.ModuleDict`` per layer, under the same
names (``segments/seg0/<l>/attn/wq``, ``segments/mamba/<l>/mamba/in_proj``),
so :func:`repro_torch.models.convert.load_jax_params` carries a JAX parameter
tree across by name.  A model holds its weights and exposes ``repro``'s
surface without the params argument: ``loss_fn(batch) -> (loss, metrics)``,
``forward(batch)``, ``init_cache(batch, max_len)`` and ``decode_step(cache,
tokens, pos) -> (logits, cache)``; the cache is updated in place, which
stands in for the JAX package's donated cache buffers.  ``param_tree()`` is
the parameter tree a train step differentiates and updates: the model's own
tensors by their dotted names.

Training follows the config as ``repro`` does: ``remat`` ("none", "full":
each layer recomputed in the backward pass, "dots": each layer recomputed
but for its matmuls' outputs, by ``torch.utils.checkpoint``'s selective
policy), ``bwd_bf16_boundary`` (the decoder's block outputs),
``chunked_ce`` / ``ce_chunk`` and ``z_loss`` (the decoder's loss; the SSM
stack's takes ``z_loss`` only, as ``repro``'s does).

Families ``moe``, ``vlm``, ``audio`` and ``hybrid``, MLA attention, MTP and
the int8 KV cache raise ``NotImplementedError`` (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (GQAConfig, KVCache, gqa_attend, gqa_decode,
                                          init_gqa, init_gqa_cache)
from repro_torch.models.common import (bf16_boundary, chunked_softmax_cross_entropy,
                                       dense_init, embed_init, layer_norm, params, rms_norm,
                                       softmax_cross_entropy)
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


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------

# the matmuls "dots" keeps for the backward pass (x @ W flattens to mm; an
# einsum becomes bmm); everything else in a layer is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_policy)


def _layer(fn: Callable, remat: str, *args):
    """``fn(*args)`` for one layer, rematerialised in the backward pass as
    ``remat`` says; with no gradient to record it is a plain call."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=_dots_context)
    raise ValueError(f"unknown remat {remat!r} (none | full | dots)")


class Model(nn.Module):
    """A model of the port (``repro``'s ``Model``, holding its weights): the
    embedding, final norm and head shared by both families."""

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

    def _labels(self, batch) -> torch.Tensor:
        return torch.as_tensor(batch["labels"], device=self.device)

    def param_tree(self) -> Dict[str, nn.Parameter]:
        """The parameters by dotted name (``segments.seg0.3.attn.wq``): the
        tree a train step differentiates, updates and checkpoints."""
        return dict(self.named_parameters())


# ---------------------------------------------------------------------------
# decoder LM (dense)
# ---------------------------------------------------------------------------


class DecoderLM(Model):
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

    def _block(self, blk, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = x + gqa_attend(blk["attn"], _norm(x, blk["norm1"], cfg), self.gqa)
        x = x + dense_ffn(blk["ffn"], _norm(x, blk["norm2"], cfg), kind=cfg.ffn_kind)
        if cfg.bwd_bf16_boundary:
            x = bf16_boundary(x)          # bf16 backward across block boundaries
        return x

    def _trunk(self, tokens) -> torch.Tensor:
        x = self._embed(tokens)
        for blk in self.segments["seg0"]:
            x = _layer(self._block, self.cfg.remat, blk, x)
        return x

    def forward(self, batch) -> torch.Tensor:
        """Prefill: logits (B, T, V), or (B, 1, V) under ``prefill_last_only``."""
        x = self._trunk(batch["tokens"])
        if self.cfg.prefill_last_only:
            x = x[:, -1:]                 # serving: only next-token logits
        return self._logits(x)

    def loss_fn(self, batch):
        """Mean next-token CE (plus z-loss) of ``batch`` (tokens, labels):
        ``(loss, {"ce", "aux"})``; ``aux`` is 0 (MoE's balance loss in
        ``repro``)."""
        cfg = self.cfg
        x = _norm(self._trunk(batch["tokens"]), self.final_norm, cfg)
        labels = self._labels(batch)
        if cfg.chunked_ce:
            loss = chunked_softmax_cross_entropy(x, self.head["w"], labels,
                                                 chunk=cfg.ce_chunk, z_loss=cfg.z_loss)
        else:
            loss = softmax_cross_entropy(x @ self.head["w"], labels, z_loss=cfg.z_loss)
        aux = torch.zeros((), device=self.device)
        return loss + aux, {"ce": loss, "aux": aux}

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


class SSMLM(Model):
    def __init__(self, cfg: ArchConfig, device: torch.device, generator: torch.Generator):
        super().__init__(cfg, device, generator)
        self.ssm = _ssm_cfg(cfg)
        dtype = _dtype(cfg)
        self.segments = nn.ModuleDict({"mamba": nn.ModuleList([
            nn.ModuleDict({"norm": _init_norm(cfg, dtype, device),
                           "mamba": init_mamba2(self.ssm, dtype=dtype, device=device,
                                                generator=generator)})
            for _ in range(cfg.n_layers)])})

    def _block(self, blk, x: torch.Tensor) -> torch.Tensor:
        return x + mamba2_forward(blk["mamba"], _norm(x, blk["norm"], self.cfg), self.ssm)

    def forward(self, batch) -> torch.Tensor:
        x = self._embed(batch["tokens"])
        for blk in self.segments["mamba"]:
            x = _layer(self._block, self.cfg.remat, blk, x)
        return self._logits(x)

    def loss_fn(self, batch):
        """Mean next-token CE (plus z-loss) of ``batch``: ``(loss, {"ce"})``."""
        loss = softmax_cross_entropy(self.forward(batch), self._labels(batch),
                                     z_loss=self.cfg.z_loss)
        return loss, {"ce": loss}

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
                generator: Optional[torch.Generator] = None) -> Model:
    """The model of ``cfg`` on ``device`` (``None``: the card), its weights
    drawn from ``generator`` (default: seed 0 on that device)."""
    if cfg.family in DEFERRED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet (ROADMAP "
                                  f"Queue 1 item 11, {DEFERRED_FAMILIES[cfg.family]})")
    if cfg.attn_kind == "mla":
        raise NotImplementedError("MLA attention is not ported yet (ROADMAP Queue 1 "
                                  "item 11, deferred item 2)")
    if cfg.mtp:
        raise NotImplementedError("multi-token prediction comes with MLA (ROADMAP Queue 1 "
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
