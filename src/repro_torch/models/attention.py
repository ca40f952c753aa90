"""Attention: GQA/MHA (+ qk-norm, qkv-bias, RoPE), MLA and cross-attention,
for prefill and decode.

Port of :mod:`repro.models.attention`.  Prefill runs one of three
implementations of the same function (``GQAConfig.attention_impl``):
``"naive"`` materialises the scores, ``"blocked"`` is the online softmax
over KV blocks in plain PyTorch, and ``"pallas"`` (the name kept from
``repro``) is the hand-written flash attention kernel
(:mod:`repro_torch.kernels.flash_attention`).  Decode attends one query step
over the KV cache with :func:`naive_attention`, as ``repro`` does; no kernel
runs there.  The cache is a :class:`KVCache` in the cache dtype or a
:class:`QuantKVCache` of int8 codes with a bf16 scale per (token, head):
:func:`gqa_decode` writes the new token's codes and scales in place and
dequantizes the whole cache each step, as ``repro`` does.

MLA (deepseek-v3's multi-head latent attention) expands its compressed
cache into per-head keys (nope + rope, dk = dn + dr) and values (dv) for
prefill, so the flash kernel runs it as MHA with dk != dv; its decode is
the *absorbed* form, queries projected into the compressed c-space, so the
cache stays at ``kv_lora_rank + qk_rope_dim`` a token.

Cross-attention (llama-3.2-vision, :func:`cross_attend`) attends text
queries over the projected vision tokens, non-causally and without RoPE, so
under ``"pallas"`` the flash kernel runs it with T != S.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Union

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.common import Seed, apply_rope, dense_init, init_stream, params, rms_norm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------


def naive_attention(q, k, v, *, causal: bool, q_offset: int = 0) -> torch.Tensor:
    """Reference full-materialisation attention.

    q: (B, T, KH, G, dh); k, v: (B, S, KH, dh).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("btkgd,bskd->btkgs", q.float(), k.float()) * scale
    if causal:
        tpos = q_offset + torch.arange(q.shape[1], device=q.device)
        spos = torch.arange(k.shape[1], device=q.device)
        mask = tpos[:, None] >= spos[None, :]
        scores = scores.masked_fill(~mask[None, :, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkgs,bskd->btkgd", w, v.float())
    return out.to(q.dtype)


def blocked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      block_k: int = 512) -> torch.Tensor:
    """Online-softmax attention over KV blocks (flash-style, plain PyTorch).

    q: (B, T, KH, G, dk); k: (B, S, KH, dk); v: (B, S, KH, dv)  →  (B, T, KH, G, dv)
    """
    B, T, KH, G, dk = q.shape
    dv = v.shape[-1]
    S = k.shape[1]
    scale = 1.0 / math.sqrt(dk)
    nblk = (S + block_k - 1) // block_k
    pad = nblk * block_k - S
    if pad:
        k = nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qf = q.float()
    tpos = q_offset + torch.arange(T, device=q.device)
    m = torch.full((B, T, KH, G), float("-inf"), device=q.device)
    l = torch.zeros((B, T, KH, G), device=q.device)
    acc = torch.zeros((B, T, KH, G, dv), device=q.device)
    for j in range(nblk):
        kj = k[:, j * block_k:(j + 1) * block_k].float()
        vj = v[:, j * block_k:(j + 1) * block_k].float()
        s = torch.einsum("btkgd,bskd->btkgs", qf, kj) * scale
        spos = j * block_k + torch.arange(block_k, device=q.device)
        valid = spos < S
        if causal:
            mask = (tpos[:, None] >= spos[None, :]) & valid[None, :]
        else:
            mask = valid[None, :].expand(T, block_k)
        s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("btkgs,bskd->btkgd", p, vj)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.to(q.dtype)


def _run_attention(q, k, v, *, causal: bool, q_offset: int = 0, impl: str = "blocked",
                   block_k: int = 512) -> torch.Tensor:
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, q_offset=q_offset)
    if impl == "pallas":
        return fa_ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    if impl == "blocked":
        return blocked_attention(q, k, v, causal=causal, q_offset=q_offset, block_k=block_k)
    raise ValueError(f"unknown attention_impl {impl!r} (naive | blocked | pallas)")


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


class GQAConfig(NamedTuple):
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    causal: bool = True
    attention_impl: str = "blocked"   # naive | blocked | pallas (the CUDA kernel)
    block_k: int = 512


def init_gqa(cfg: GQAConfig, *, dtype=torch.float32, device=None,
             generator: Seed = None) -> nn.ParameterDict:
    generator = init_stream(generator)
    D, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device, generator=generator)
    p = {
        "wq": dense_init((D, H, hd), in_axis=0, **kw),
        "wk": dense_init((D, KH, hd), in_axis=0, **kw),
        "wv": dense_init((D, KH, hd), in_axis=0, **kw),
        "wo": dense_init((H, hd, D), in_axis=1, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KH, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KH, hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return params(p)


def _gqa_qkv(p, x, cfg: GQAConfig, positions):
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", x, p["wk"])
    v = torch.einsum("btd,dhk->bthk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attend(p, x, cfg: GQAConfig, *, positions=None) -> torch.Tensor:
    """Full-sequence (train / prefill) self-attention."""
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device).expand(B, T)
    q, k, v = _gqa_qkv(p, x, cfg, positions)
    G = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, T, cfg.n_kv_heads, G, cfg.head_dim)
    out = _run_attention(qg, k, v, causal=cfg.causal, impl=cfg.attention_impl,
                         block_k=cfg.block_k)
    out = out.reshape(B, T, cfg.n_heads, cfg.head_dim)
    return torch.einsum("bthk,hkd->btd", out, p["wo"])


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S, KH, hd)
    v: torch.Tensor
    # position is tracked by the caller (one scalar for the whole stack)


class QuantKVCache(NamedTuple):
    """int8 KV cache with a scale per (token, head), ``repro``'s: half the
    decode cache reads of bf16."""

    k_q: torch.Tensor    # (B, S, KH, hd) int8
    k_s: torch.Tensor    # (B, S, KH, 1)  bf16 scale
    v_q: torch.Tensor
    v_s: torch.Tensor


def _quantize_i8(x: torch.Tensor):
    """x (..., hd) → (int8 codes, bf16 scale (..., 1)): the fp32 absolute max
    over the head dim over 127, floored at 1e-8; x / scale in fp32, rounded
    half to even and clipped to ±127."""
    xf = x.float()
    # 127 as a tensor on x's device: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which rounds apart from repro's
    # division (and from the CPU's)
    scale = torch.clamp_min(xf.abs().amax(-1, keepdim=True) / xf.new_tensor(127.0), 1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _dequantize_i8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale.float()


def init_gqa_cache(cfg: GQAConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None, quantized: bool = False) -> Union[KVCache, QuantKVCache]:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    if quantized:
        sshape = shape[:-1] + (1,)

        def zeros(sh, dt):
            return torch.zeros(sh, dtype=dt, device=device)

        return QuantKVCache(zeros(shape, torch.int8), zeros(sshape, torch.bfloat16),
                            zeros(shape, torch.int8), zeros(sshape, torch.bfloat16))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def gqa_decode(p, cache: Union[KVCache, QuantKVCache], x_t, cfg: GQAConfig, pos: int):
    """One-token decode: x_t (B, 1, D), pos int — returns (cache, out).

    The new K/V are written into ``cache`` in place (what the JAX package
    gets from donating the cache), and the same cache is returned; an int8
    :class:`QuantKVCache` takes the new token's codes and scales and is
    dequantized whole for the step's attention."""
    B = x_t.shape[0]
    positions = torch.full((B, 1), pos, device=x_t.device)
    q, k_t, v_t = _gqa_qkv(p, x_t, cfg, positions)
    if isinstance(cache, QuantKVCache):
        for buf, val in zip(cache, (*_quantize_i8(k_t), *_quantize_i8(v_t))):
            buf[:, pos:pos + 1] = val
        k = _dequantize_i8(cache.k_q, cache.k_s).to(x_t.dtype)
        v = _dequantize_i8(cache.v_q, cache.v_s).to(x_t.dtype)
    else:
        cache.k[:, pos:pos + 1] = k_t.to(cache.k.dtype)
        cache.v[:, pos:pos + 1] = v_t.to(cache.v.dtype)
        k, v = cache.k, cache.v
    G = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, 1, cfg.n_kv_heads, G, cfg.head_dim)
    # mask out cache positions beyond pos via the causal mask with q_offset=pos
    out = naive_attention(qg, k, v, causal=True, q_offset=pos)
    out = out.reshape(B, 1, cfg.n_heads, cfg.head_dim)
    return cache, torch.einsum("bthk,hkd->btd", out, p["wo"])


# ---------------------------------------------------------------------------
# Cross-attention (llama-3.2-vision): queries from text, K/V from vision tokens
# ---------------------------------------------------------------------------


def cross_attend(p, x, kv_embeds, cfg: GQAConfig) -> torch.Tensor:
    """x (B, T, D) attends over kv_embeds (B, Sv, D); non-causal, no RoPE (and
    no qkv bias, as in ``repro``)."""
    B, T, _ = x.shape
    q = torch.einsum("btd,dhk->bthk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_embeds, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_embeds, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    G = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, T, cfg.n_kv_heads, G, cfg.head_dim)
    out = _run_attention(qg, k, v, causal=False, impl=cfg.attention_impl,
                         block_k=cfg.block_k)
    out = out.reshape(B, T, cfg.n_heads, cfg.head_dim)
    return torch.einsum("bthk,hkd->btd", out, p["wo"])


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (deepseek-v3)
# ---------------------------------------------------------------------------


class MLAConfig(NamedTuple):
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    attention_impl: str = "blocked"   # naive | blocked | pallas (the CUDA kernel)
    block_k: int = 512


def init_mla(cfg: MLAConfig, *, dtype=torch.float32, device=None,
             generator: Seed = None) -> nn.ParameterDict:
    generator = init_stream(generator)
    D, H = cfg.d_model, cfg.n_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kw = dict(dtype=dtype, device=device, generator=generator)
    return params({
        "w_dq": dense_init((D, r_q), in_axis=0, **kw),
        "q_norm": torch.ones((r_q,), dtype=dtype, device=device),
        "w_uq": dense_init((r_q, H, dn + dr), in_axis=0, **kw),
        "w_dkv": dense_init((D, r_kv), in_axis=0, **kw),
        "kv_norm": torch.ones((r_kv,), dtype=dtype, device=device),
        "w_kr": dense_init((D, dr), in_axis=0, **kw),
        "w_uk": dense_init((r_kv, H, dn), in_axis=0, **kw),
        "w_uv": dense_init((r_kv, H, dv), in_axis=0, **kw),
        "wo": dense_init((H, dv, D), in_axis=1, **kw),
    })


def _mla_q(p, x, cfg: MLAConfig, positions):
    cq = rms_norm(torch.einsum("btd,dr->btr", x, p["w_dq"]), p["q_norm"])
    q = torch.einsum("btr,rhk->bthk", cq, p["w_uq"])
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_ckv(p, x, cfg: MLAConfig, positions):
    c_kv = rms_norm(torch.einsum("btd,dr->btr", x, p["w_dkv"]), p["kv_norm"])
    k_rope = torch.einsum("btd,dk->btk", x, p["w_kr"])[:, :, None, :]   # shared head
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_attend(p, x, cfg: MLAConfig, *, positions=None) -> torch.Tensor:
    """Train/prefill MLA: expand c_kv to per-head K/V and attend, every head
    its own KV group (KH = H, G = 1; dk = dn + dr, dv = v_head_dim)."""
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device).expand(B, T)
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_ckv(p, x, cfg, positions)
    k_nope = torch.einsum("btr,rhk->bthk", c_kv, p["w_uk"])
    v = torch.einsum("btr,rhk->bthk", c_kv, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)                          # (B, T, H, dn+dr)
    del q_nope, q_rope
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, T, H, dr)], dim=-1)
    del k_nope, c_kv
    out = _run_attention(q.reshape(B, T, H, 1, dn + dr), k, v, causal=True,
                         impl=cfg.attention_impl, block_k=cfg.block_k)
    del q, k, v
    out = out.reshape(B, T, H, cfg.v_head_dim)
    return torch.einsum("bthk,hkd->btd", out, p["wo"])


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, S, kv_lora_rank) — the compressed cache
    k_rope: torch.Tensor  # (B, S, qk_rope_dim)


def init_mla_cache(cfg: MLAConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None) -> MLACache:
    return MLACache(
        torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype, device=device),
        torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype, device=device),
    )


def mla_decode(p, cache: MLACache, x_t, cfg: MLAConfig, pos: int):
    """Absorbed-matrix MLA decode: score/readout directly in c-space.

    scores_h(s) = q_nope_h · (W_uk_h c_s) + q_rope_h · k_rope_s
                = (W_uk_hᵀ q_nope_h) · c_s + q_rope_h · k_rope_s
    out_h       = Σ_s p_h(s) (W_uv_h c_s) = W_uv_h (Σ_s p_h(s) c_s)

    x_t (B, 1, D), pos int — returns (cache, out); the new entries are
    written into ``cache`` in place, as :func:`gqa_decode`'s are.  The
    absorbed query is made in the model's dtype, the scores and readout in
    fp32, and the readout cast back to the model's dtype before ``w_uv``,
    as ``repro`` orders them."""
    B = x_t.shape[0]
    positions = torch.full((B, 1), pos, device=x_t.device)
    q_nope, q_rope = _mla_q(p, x_t, cfg, positions)                  # (B, 1, H, ·)
    c_t, kr_t = _mla_ckv(p, x_t, cfg, positions)                     # (B, 1, r), (B, 1, dr)
    cache.c_kv[:, pos:pos + 1] = c_t.to(cache.c_kv.dtype)
    cache.k_rope[:, pos:pos + 1] = kr_t.to(cache.k_rope.dtype)
    c_kv = cache.c_kv.float()

    q_c = torch.einsum("bthk,rhk->bthr", q_nope, p["w_uk"])          # absorbed query
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    s_c = torch.einsum("bthr,bsr->bths", q_c.float(), c_kv)
    s_r = torch.einsum("bthk,bsk->bths", q_rope.float(), cache.k_rope.float())
    scores = (s_c + s_r) * scale                                     # (B, 1, H, S)
    spos = torch.arange(c_kv.shape[1], device=x_t.device)
    scores = scores.masked_fill((spos > pos)[None, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o_c = torch.einsum("bths,bsr->bthr", w, c_kv)                    # (B, 1, H, r)
    out = torch.einsum("bthr,rhk->bthk", o_c.to(x_t.dtype), p["w_uv"])
    return cache, torch.einsum("bthk,hkd->btd", out, p["wo"])
