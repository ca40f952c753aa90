"""Model assembly: decoder LMs (dense, MoE and vision), Mamba2 stacks,
zamba2 hybrids and the audio encoder, for serving and training.

Port of :mod:`repro.models.build` for all six families:

  dense — decoder transformer, GQA attention and a dense FFN (one segment of
      ``"self"`` blocks; ``prefill_last_only`` honoured).
  moe — decoder transformer whose first ``first_dense_layers`` blocks have
      a dense FFN (``"self_wide"``, ``d_ff_dense`` wide; segment ``seg0``)
      and the rest a Mixture-of-Experts FFN (``"self_moe"``; ``seg1``),
      with GQA or MLA attention; the blocks carry the MoE balance loss
      (``aux``) that ``loss_fn`` adds.  deepseek-v3's MTP head (``mtp``:
      ``proj``, one ``self_wide`` block, three norms) adds its next-next-
      token CE times ``mtp_weight``.
  vlm — llama-3.2-vision: ``n_layers // cross_attn_period`` superblocks
      (segment ``seg0`` of ``"vlm_super"`` units), each ``cross_attn_period
      - 1`` self-attention blocks (``self``) closed by one cross-attention
      block (``cross``) whose queries attend non-causally over the
      projected vision tokens (``batch["vision_embeds"]`` through
      ``vision_proj`` where ``vision_dim != d_model``).  Decode attends
      over each cross block's cached vision K/V; ``init_cache`` makes them
      zeros and ``decode_step`` leaves them as they are, as ``repro``'s
      do, so a served vlm sees no image (ROADMAP Queue 3).
  ssm — Mamba2 (SSD) stack, attention-free.
  hybrid — zamba2: ``n_layers // hybrid_period`` superblocks, each
      ``hybrid_period`` Mamba2 blocks followed by one attention + FFN block
      whose weights all superblocks share (``shared_block``, one weight set
      whose gradient sums over its applications).  Decode keeps one KV cache
      per application.  Built by :class:`SSMLM`, as ``repro``'s
      ``build_ssm`` builds both.
  audio — hubert: an encoder-only stack of non-causal ``"self"`` blocks
      over ``batch["frames"]`` (``in_proj``), a per-frame classification
      head and CE (:class:`AudioEncoder`); no decode (``init_cache`` and
      ``decode_step`` are ``None``).

``repro``'s stacked parameters with a leading layer axis become an
``nn.ModuleList`` with one ``nn.ModuleDict`` per layer, under the same
names (``segments/seg0/<l>/attn/wq``, ``segments/mamba/<l>/mamba/in_proj``;
the hybrid's doubly stacked ``segments/mamba/<s>/<i>/...`` a list of lists,
the vlm's ``segments/seg0/<s>/self/<i>/...`` beside ``.../<s>/cross/...``),
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
policy; the hybrid's unit is the superblock), ``bwd_bf16_boundary`` (the
attention blocks' outputs), ``chunked_ce`` / ``ce_chunk`` and ``z_loss``
(the decoder's loss; the SSM and hybrid stacks' take ``z_loss`` only, as
``repro``'s do; the audio encoder's takes neither).

``kv_cache_dtype="int8"`` gives the GQA caches of the dense and moe families
int8 codes with bf16 scales (:class:`~repro_torch.models.attention.
QuantKVCache`); MLA, the hybrid's shared block and the vlm keep theirs, as in
``repro``.  ``moe_impl="ep"`` runs the forward's MoE layers over the mesh
that :func:`repro_torch.launch.shardings.set_mesh_axis_sizes` registered
(``build_cell`` and ``train`` register theirs); decode routes by the gather
path, as ``repro``'s does.  On ``device="meta"`` nothing is allocated and
no weight is drawn (the shapes of ``repro``'s ``jax.eval_shape``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (GQAConfig, KVCache, MLACache, MLAConfig,
                                          QuantKVCache, cross_attend, gqa_attend, gqa_decode,
                                          init_gqa, init_gqa_cache, init_mla, init_mla_cache,
                                          mla_attend, mla_decode, naive_attention)
from repro_torch.models.common import (InitStream, Seed, Tree, bf16_boundary,
                                       chunked_softmax_cross_entropy, dense_init, embed_init,
                                       init_stream, layer_norm, params, rms_norm,
                                       softmax_cross_entropy)
from repro_torch.models.ffn import MoEConfig, dense_ffn, init_dense_ffn, init_moe
from repro_torch.models.mamba import (MambaCache, SSMConfig, init_mamba2,
                                      init_mamba_cache, mamba2_decode, mamba2_forward)


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


def _mla_cfg(cfg: ArchConfig) -> MLAConfig:
    return MLAConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        q_lora_rank=cfg.q_lora_rank,
        kv_lora_rank=cfg.kv_lora_rank,
        qk_nope_dim=cfg.qk_nope_dim,
        qk_rope_dim=cfg.qk_rope_dim,
        v_head_dim=cfg.v_head_dim,
        rope_theta=cfg.rope_theta,
        attention_impl=cfg.attention_impl,
        block_k=cfg.block_k,
    )


def _moe_cfg(cfg: ArchConfig, data_groups: int) -> MoEConfig:
    return MoEConfig(
        d_model=cfg.d_model,
        n_experts=cfg.n_experts,
        top_k=cfg.top_k,
        d_ff_expert=cfg.d_ff_expert,
        n_shared=cfg.n_shared_experts,
        capacity_factor=cfg.capacity_factor,
        impl=cfg.moe_impl,
        aux_loss_weight=cfg.aux_loss_weight,
        data_groups=data_groups,
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
    token embedding (which the audio encoder has not), final norm and head
    shared by the families."""

    def __init__(self, cfg: ArchConfig, device: torch.device, generator: InitStream,
                 *, embed: bool = True):
        super().__init__()
        self.cfg = cfg
        self.device = device
        dtype = _dtype(cfg)
        kw = dict(dtype=dtype, device=device, generator=generator)
        V, D = cfg.vocab, cfg.d_model
        if embed:
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
# the attention + FFN block (the decoder's layers, the hybrid's shared block)
# ---------------------------------------------------------------------------

AttnConfig = Union[GQAConfig, MLAConfig]


def _init_attn(attn: AttnConfig, **kw) -> nn.ParameterDict:
    return init_mla(attn, **kw) if isinstance(attn, MLAConfig) else init_gqa(attn, **kw)


def _init_block(cfg: ArchConfig, attn: AttnConfig, device, generator, *, ffn: str = "dense",
                moe_cfg: Optional[MoEConfig] = None) -> nn.ModuleDict:
    """``repro``'s ``_init_block``: ``ffn`` "dense" (``d_ff`` wide),
    "dense_wide" (``d_ff_dense``, or ``d_ff`` where that is 0) or "moe"
    (under the key ``moe``, as in ``repro``)."""
    dtype = _dtype(cfg)
    kw = dict(dtype=dtype, device=device, generator=generator)
    blk = {"norm1": _init_norm(cfg, dtype, device), "norm2": _init_norm(cfg, dtype, device),
           "attn": _init_attn(attn, **kw)}
    if ffn == "moe":
        blk["moe"] = init_moe(moe_cfg, **kw)
    else:
        width = (cfg.d_ff_dense or cfg.d_ff) if ffn == "dense_wide" else cfg.d_ff
        blk["ffn"] = init_dense_ffn(cfg.d_model, width, kind=cfg.ffn_kind, bias=cfg.ffn_bias,
                                    **kw)
    return nn.ModuleDict(blk)


def _attend(p, x: torch.Tensor, attn: AttnConfig) -> torch.Tensor:
    if isinstance(attn, MLAConfig):
        return mla_attend(p, x, attn)
    return gqa_attend(p, x, attn)


def _block_fwd(blk, x: torch.Tensor, aux, cfg: ArchConfig, attn: AttnConfig,
               moe_cfg: Optional[MoEConfig] = None, kind: str = "self",
               vision: Optional[torch.Tensor] = None):
    """``repro``'s ``_block_fwd`` for a ``"self"``, ``"self_wide"``,
    ``"self_moe"`` or ``"cross"`` block (attending over ``vision``):
    ``(x, aux)``, a MoE block's balance loss added to ``aux``."""
    h = _norm(x, blk["norm1"], cfg)
    if kind == "cross":
        x = x + cross_attend(blk["attn"], h, vision, attn)
    else:
        x = x + _attend(blk["attn"], h, attn)
    h = _norm(x, blk["norm2"], cfg)
    if kind == "self_moe":
        y, al = blk["moe"](h, moe_cfg)
        aux = aux + al
    else:
        y = dense_ffn(blk["ffn"], h, kind=cfg.ffn_kind)
    x = x + y
    if cfg.bwd_bf16_boundary:
        x = bf16_boundary(x)          # bf16 backward across block boundaries
    return x, aux


def _cross_decode(p, cache: KVCache, x_t: torch.Tensor, gqa: GQAConfig) -> torch.Tensor:
    """Decode-time cross-attention over the cached vision K/V (non-causal)."""
    B = x_t.shape[0]
    q = torch.einsum("btd,dhk->bthk", x_t, p["wq"])
    if gqa.qk_norm:
        q = rms_norm(q, p["q_norm"])
    G = gqa.n_heads // gqa.n_kv_heads
    qg = q.reshape(B, 1, gqa.n_kv_heads, G, gqa.head_dim)
    out = naive_attention(qg, cache.k, cache.v, causal=False)
    out = out.reshape(B, 1, gqa.n_heads, gqa.head_dim)
    return torch.einsum("bthk,hkd->btd", out, p["wo"])


def _block_decode(blk, cache: Union[KVCache, QuantKVCache, MLACache], x: torch.Tensor,
                  cfg: ArchConfig, attn: AttnConfig, pos: int,
                  moe_cfg: Optional[MoEConfig] = None, kind: str = "self") -> torch.Tensor:
    """``repro``'s ``_block_decode``; ``cache`` is updated in place (a
    ``"cross"`` block's only read).  An MoE block routes the step's tokens
    in one group, ``ep`` by the gather path."""
    h = _norm(x, blk["norm1"], cfg)
    if kind == "cross":
        a = _cross_decode(blk["attn"], cache, h, attn)
    elif isinstance(attn, MLAConfig):
        _, a = mla_decode(blk["attn"], cache, h, attn, pos)
    else:
        _, a = gqa_decode(blk["attn"], cache, h, attn, pos)
    x = x + a
    h = _norm(x, blk["norm2"], cfg)
    if kind == "self_moe":
        y, _ = blk["moe"](h, moe_cfg._replace(
            data_groups=1, impl="gather" if moe_cfg.impl == "ep" else moe_cfg.impl))
    else:
        y = dense_ffn(blk["ffn"], h, kind=cfg.ffn_kind)
    return x + y


# ---------------------------------------------------------------------------
# decoder LM (dense, moe, vlm)
# ---------------------------------------------------------------------------

_SEGMENT_FFN = {"self": "dense", "self_wide": "dense_wide", "self_moe": "moe"}


class DecoderLM(Model):
    """The ``dense``, ``moe`` and ``vlm`` families: ``seg_plan`` as
    ``repro``'s, one ``nn.ModuleList`` of units a segment
    (``segments.seg<i>``): a block, or the vlm's superblock, an
    ``nn.ModuleDict`` of ``self`` (a list of ``cross_attn_period - 1``
    blocks) and ``cross`` (one block)."""

    def __init__(self, cfg: ArchConfig, device: torch.device, generator: InitStream,
                 data_groups: int = 1):
        super().__init__(cfg, device, generator)
        if cfg.attn_kind == "mla":
            self.mla = _mla_cfg(cfg)
        else:
            self.gqa = _gqa_cfg(cfg)
        self.moe_cfg = _moe_cfg(cfg, data_groups) if cfg.n_experts else None
        self.vlm = cfg.family == "vlm"
        self.seg_plan = []
        if self.vlm:
            self.period = cfg.cross_attn_period
            self.seg_plan.append(("vlm_super", cfg.n_layers // self.period))
        else:
            n_dense = cfg.first_dense_layers if cfg.n_experts else cfg.n_layers
            if n_dense:
                self.seg_plan.append(
                    ("self_wide" if (cfg.n_experts and cfg.d_ff_dense) else "self", n_dense))
            if cfg.n_experts and cfg.n_layers - n_dense > 0:
                self.seg_plan.append(("self_moe", cfg.n_layers - n_dense))

        def unit(kind: str) -> nn.ModuleDict:
            if kind == "vlm_super":
                return nn.ModuleDict({
                    "self": nn.ModuleList([_init_block(cfg, self.gqa, device, generator)
                                           for _ in range(self.period - 1)]),
                    "cross": _init_block(cfg, self.gqa, device, generator)})
            return _init_block(cfg, self.attn_cfg, device, generator, ffn=_SEGMENT_FFN[kind],
                               moe_cfg=self.moe_cfg)

        self.segments = nn.ModuleDict({f"seg{i}": nn.ModuleList([unit(kind) for _ in range(n)])
                                       for i, (kind, n) in enumerate(self.seg_plan)})
        if self.vlm and cfg.vision_dim and cfg.vision_dim != cfg.d_model:
            self.vision_proj = params({"w": dense_init(
                (cfg.vision_dim, cfg.d_model), in_axis=0, dtype=_dtype(cfg), device=device,
                generator=generator)})
        if cfg.mtp:
            dtype = _dtype(cfg)
            D = cfg.d_model
            self.mtp = Tree(
                {"proj": dense_init((2 * D, D), in_axis=0, dtype=dtype, device=device,
                                    generator=generator)},
                {"block": _init_block(cfg, self.attn_cfg, device, generator,
                                      ffn="dense_wide" if cfg.n_experts else "dense"),
                 "norm_h": _init_norm(cfg, dtype, device),
                 "norm_e": _init_norm(cfg, dtype, device),
                 "final_norm": _init_norm(cfg, dtype, device)})

    @property
    def attn_cfg(self) -> AttnConfig:
        """The attention layers' config: ``mla`` or ``gqa`` (the model's
        attribute; replace it to switch the implementation)."""
        return self.mla if self.cfg.attn_kind == "mla" else self.gqa

    def _segments(self):
        for i, (kind, _) in enumerate(self.seg_plan):
            yield kind, self.segments[f"seg{i}"], f"seg{i}"

    def _block(self, blk, x: torch.Tensor, aux: torch.Tensor, kind: str,
               vision: Optional[torch.Tensor] = None):
        """One unit of a segment; the remat unit is a block, or the vlm's
        superblock (``repro``'s scan body)."""
        if kind == "vlm_super":
            for b in blk["self"]:
                x, aux = _block_fwd(b, x, aux, self.cfg, self.gqa)
            return _block_fwd(blk["cross"], x, aux, self.cfg, self.gqa, kind="cross",
                              vision=vision)
        return _block_fwd(blk, x, aux, self.cfg, self.attn_cfg, self.moe_cfg, kind)

    def _vision_of(self, batch) -> Optional[torch.Tensor]:
        """The vlm's vision tokens (B, Sv, D): ``batch["vision_embeds"]`` in the
        model's dtype, through ``vision_proj`` where there is one."""
        if not self.vlm:
            return None
        v = torch.as_tensor(batch["vision_embeds"], device=self.device).to(_dtype(self.cfg))
        if hasattr(self, "vision_proj"):
            v = v @ self.vision_proj["w"]
        return v

    def _trunk(self, tokens, vision: Optional[torch.Tensor] = None):
        x = self._embed(tokens)
        aux = torch.zeros((), device=self.device)
        for kind, blocks, _ in self._segments():
            for blk in blocks:
                x, aux = _layer(self._block, self.cfg.remat, blk, x, aux, kind, vision)
        return x, aux

    def forward(self, batch) -> torch.Tensor:
        """Prefill: logits (B, T, V), or (B, 1, V) under ``prefill_last_only``."""
        x, _ = self._trunk(batch["tokens"], self._vision_of(batch))
        if self.cfg.prefill_last_only:
            x = x[:, -1:]                 # serving: only next-token logits
        return self._logits(x)

    def loss_fn(self, batch):
        """Mean next-token CE (plus z-loss) of ``batch`` (tokens, labels),
        plus the MoE balance loss ``aux`` (0 without MoE) and, with MTP,
        ``mtp_weight`` times the MTP head's CE: ``(loss + aux, {"ce",
        "aux"[, "mtp"]})``."""
        cfg = self.cfg
        h, aux = self._trunk(batch["tokens"], self._vision_of(batch))
        x = _norm(h, self.final_norm, cfg)
        labels = self._labels(batch)
        if cfg.chunked_ce:
            loss = chunked_softmax_cross_entropy(x, self.head["w"], labels,
                                                 chunk=cfg.ce_chunk, z_loss=cfg.z_loss)
        else:
            loss = softmax_cross_entropy(x @ self.head["w"], labels, z_loss=cfg.z_loss)
        del x
        metrics = {"ce": loss, "aux": aux}
        if cfg.mtp:
            m = self.mtp
            emb_next = nn.functional.embedding(labels.long(), self.embed["table"])
            hcat = torch.cat([_norm(h, m["norm_h"], cfg), _norm(emb_next, m["norm_e"], cfg)],
                             dim=-1)
            hm, _ = _block_fwd(m["block"], hcat @ m["proj"], None, cfg, self.attn_cfg,
                               self.moe_cfg, "self_wide" if cfg.n_experts else "self")
            hm = _norm(hm, m["final_norm"], cfg)
            mtp_loss = softmax_cross_entropy(hm[:, :-1] @ self.head["w"], labels[:, 1:])
            metrics["mtp"] = mtp_loss
            loss = loss + cfg.mtp_weight * mtp_loss
        return loss + aux, metrics

    def init_cache(self, batch: int, max_len: int) -> Dict[str, list]:
        """``{"seg<i>": [cache] * layers}``: a ``KVCache`` a layer (a
        ``QuantKVCache`` under ``kv_cache_dtype="int8"``), or an ``MLACache``
        (the compressed c_kv and the shared rope key); the vlm's is
        ``{"seg0": {"self": [[KVCache] * (period - 1)] * n_super, "cross":
        [KVCache over vision_tokens] * n_super}}``, the cross caches zeros."""
        cfg, dtype = self.cfg, _cache_dtype(self.cfg)
        if cfg.attn_kind == "mla":
            def one():
                return init_mla_cache(self.mla, batch, max_len, dtype, device=self.device)
        else:
            quantized = cfg.kv_cache_dtype == "int8" and not self.vlm

            def one(length=max_len):
                return init_gqa_cache(self.gqa, batch, length, dtype, device=self.device,
                                      quantized=quantized)
        if self.vlm:
            return {name: {"self": [[one() for _ in range(self.period - 1)] for _ in blocks],
                           "cross": [one(cfg.vision_tokens) for _ in blocks]}
                    for _, blocks, name in self._segments()}
        return {name: [one() for _ in blocks] for _, blocks, name in self._segments()}

    def decode_step(self, cache, tokens, pos: int):
        x = self._embed(tokens)
        cfg = self.cfg
        for kind, blocks, name in self._segments():
            if kind == "vlm_super":
                c = cache[name]
                for sblk, self_caches, cross in zip(blocks, c["self"], c["cross"]):
                    for blk, kv in zip(sblk["self"], self_caches):
                        x = _block_decode(blk, kv, x, cfg, self.gqa, pos)
                    x = _block_decode(sblk["cross"], cross, x, cfg, self.gqa, pos,
                                      kind="cross")
                continue
            for blk, c in zip(blocks, cache[name]):
                x = _block_decode(blk, c, x, cfg, self.attn_cfg, pos, self.moe_cfg, kind)
        return self._logits(x), cache


# ---------------------------------------------------------------------------
# SSM (mamba2) and hybrid (zamba2)
# ---------------------------------------------------------------------------


class SSMLM(Model):
    """The ``ssm`` family's Mamba2 stack, or the ``hybrid`` family's: each of
    ``n_layers // hybrid_period`` superblocks runs ``hybrid_period`` Mamba2
    blocks, then the one ``shared_block``."""

    def __init__(self, cfg: ArchConfig, device: torch.device, generator: InitStream):
        super().__init__(cfg, device, generator)
        self.ssm = _ssm_cfg(cfg)
        self.hybrid = cfg.family == "hybrid"
        dtype = _dtype(cfg)

        def mamba_block() -> nn.ModuleDict:
            return nn.ModuleDict({"norm": _init_norm(cfg, dtype, device),
                                  "mamba": init_mamba2(self.ssm, dtype=dtype, device=device,
                                                       generator=generator)})

        if self.hybrid:
            self.gqa = _gqa_cfg(cfg)
            self.period = cfg.hybrid_period
            self.n_super = cfg.n_layers // self.period
            self.segments = nn.ModuleDict({"mamba": nn.ModuleList([
                nn.ModuleList([mamba_block() for _ in range(self.period)])
                for _ in range(self.n_super)])})
            self.shared_block = _init_block(cfg, self.gqa, device, generator)
        else:
            self.segments = nn.ModuleDict({"mamba": nn.ModuleList(
                [mamba_block() for _ in range(cfg.n_layers)])})

    def _block(self, blk, x: torch.Tensor) -> torch.Tensor:
        return x + mamba2_forward(blk["mamba"], _norm(x, blk["norm"], self.cfg), self.ssm)

    def _superblock(self, blocks, x: torch.Tensor) -> torch.Tensor:
        for blk in blocks:
            x = self._block(blk, x)
        return _block_fwd(self.shared_block, x, None, self.cfg, self.gqa)[0]

    def forward(self, batch) -> torch.Tensor:
        x = self._embed(batch["tokens"])
        # the remat unit is a layer, or the hybrid's superblock (repro's scan body)
        fn = self._superblock if self.hybrid else self._block
        for unit in self.segments["mamba"]:
            x = _layer(fn, self.cfg.remat, unit, x)
        return self._logits(x)

    def loss_fn(self, batch):
        """Mean next-token CE (plus z-loss) of ``batch``: ``(loss, {"ce"})``."""
        loss = softmax_cross_entropy(self.forward(batch), self._labels(batch),
                                     z_loss=self.cfg.z_loss)
        return loss, {"ce": loss}

    def _mamba_cache(self, batch: int) -> MambaCache:
        return init_mamba_cache(self.ssm, batch, _dtype(self.cfg), device=self.device)

    def init_cache(self, batch: int, max_len: int) -> Dict[str, list]:
        """``{"mamba": [MambaCache] * n_layers}``; the hybrid's is
        ``{"mamba": [[MambaCache] * period] * n_super, "attn": [KVCache] *
        n_super}``, a KV cache for each application of the shared block."""
        if not self.hybrid:
            return {"mamba": [self._mamba_cache(batch) for _ in range(self.cfg.n_layers)]}
        return {"mamba": [[self._mamba_cache(batch) for _ in range(self.period)]
                          for _ in range(self.n_super)],
                "attn": [init_gqa_cache(self.gqa, batch, max_len, _cache_dtype(self.cfg),
                                        device=self.device)
                         for _ in range(self.n_super)]}

    def _mamba_decode(self, blk, cache: MambaCache, x: torch.Tensor) -> torch.Tensor:
        _, y = mamba2_decode(blk["mamba"], cache, _norm(x, blk["norm"], self.cfg), self.ssm)
        return x + y

    def decode_step(self, cache, tokens, pos: int):
        x = self._embed(tokens)
        if not self.hybrid:
            for blk, c in zip(self.segments["mamba"], cache["mamba"]):
                x = self._mamba_decode(blk, c, x)
            return self._logits(x), cache
        for blocks, caches, kv in zip(self.segments["mamba"], cache["mamba"], cache["attn"]):
            for blk, c in zip(blocks, caches):
                x = self._mamba_decode(blk, c, x)
            x = _block_decode(self.shared_block, kv, x, self.cfg, self.gqa, pos)
        return self._logits(x), cache


# ---------------------------------------------------------------------------
# audio encoder (hubert)
# ---------------------------------------------------------------------------


class AudioEncoder(Model):
    """The ``audio`` family: ``in_proj`` over ``batch["frames"]``, ``n_layers``
    non-causal ``"self"`` blocks (``segments.seg0``), ``final_norm`` and a
    per-frame ``head``; encoder-only, so no cache and no decode step."""

    init_cache = None
    decode_step = None

    def __init__(self, cfg: ArchConfig, device: torch.device, generator: InitStream):
        super().__init__(cfg, device, generator, embed=False)
        self.gqa = _gqa_cfg(cfg)._replace(causal=False)
        self.in_proj = params({"w": dense_init((cfg.frame_dim, cfg.d_model), in_axis=0,
                                               dtype=_dtype(cfg), device=device,
                                               generator=generator)})
        self.segments = nn.ModuleDict({"seg0": nn.ModuleList(
            [_init_block(cfg, self.gqa, device, generator) for _ in range(cfg.n_layers)])})

    def _block(self, blk, x: torch.Tensor) -> torch.Tensor:
        return _block_fwd(blk, x, None, self.cfg, self.gqa)[0]

    def forward(self, batch) -> torch.Tensor:
        """Per-frame logits (B, T, vocab)."""
        frames = torch.as_tensor(batch["frames"], device=self.device)
        x = frames.to(_dtype(self.cfg)) @ self.in_proj["w"]
        for blk in self.segments["seg0"]:
            x = _layer(self._block, self.cfg.remat, blk, x)
        return self._logits(x)

    def loss_fn(self, batch):
        """Mean per-frame CE of ``batch`` (frames, labels): ``(loss, {"ce"})``."""
        loss = softmax_cross_entropy(self.forward(batch), self._labels(batch))
        return loss, {"ce": loss}


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def build_model(cfg: ArchConfig, device=None, generator: Seed = None,
                *, data_groups: int = 1) -> Model:
    """The model of ``cfg`` on ``device`` (``None``: the card), its weights
    drawn from ``generator``'s seed (:func:`~repro_torch.models.common.init_stream`:
    an int, an :class:`InitStream`, which draws on from where it is, or a
    ``torch.Generator`` of any device, read only for its ``initial_seed()``;
    default seed 0), the same on every device; on ``"meta"`` nothing is
    drawn.  An MoE model routes its forward's tokens in ``data_groups``
    groups, as ``repro``'s ``build_model(cfg, data_groups)``."""
    if cfg.family not in ("dense", "moe", "vlm", "ssm", "hybrid", "audio"):
        raise ValueError(f"unknown family {cfg.family}")
    device = resolve_device(device)
    generator = init_stream(generator)
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, device, generator, data_groups)
    if cfg.family == "audio":
        return AudioEncoder(cfg, device, generator)
    return SSMLM(cfg, device, generator)
