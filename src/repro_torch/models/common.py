"""Shared model building blocks: init, norms, RoPE, losses.

Port of :mod:`repro.models.common`.  Parameters are tensors held in
``nn.ParameterDict``\\ s (or, where a node mixes leaves and sub-trees,
:class:`Tree`\\ s) whose keys are ``repro``'s leaf names, so a
parameter tree carries across by name (:mod:`repro_torch.models.convert`).
Every init draws from an explicit :class:`torch.Generator` on the device the
tensor is made on.  The losses are the mean next-token cross-entropy, whole
(:func:`softmax_cross_entropy`) or streamed over vocabulary chunks
(:func:`chunked_softmax_cross_entropy`); :func:`bf16_boundary` rounds the
cotangent through bf16 on its way back.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


# -- initialisation ------------------------------------------------------------


def dense_init(shape, *, in_axis: int = -2, dtype=torch.float32, device=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at ±2, times 1/√fan_in."""
    std = 1.0 / math.sqrt(shape[in_axis])
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def embed_init(shape, *, dtype=torch.float32, device=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(0.0, 1.0, generator=generator)
    return (t * 0.02).to(dtype)


def params(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    """A ``ParameterDict`` of ``tensors`` under their ``repro`` leaf names.
    Serving holds weights fixed, so no gradient is tracked; the train step
    turns it on (:func:`repro_torch.launch.steps.make_train_step`)."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class Tree(nn.Module):
    """A node of a parameter tree that holds leaves and sub-trees side by
    side under ``repro``'s names, which neither a ``ParameterDict`` nor a
    ``ModuleDict`` can: an MoE layer's ``router`` and expert weights beside
    its ``shared`` FFN, MTP's ``proj`` beside its block and norms.  Read by
    name as those are (``tree["proj"]``, ``"shared" in tree``)."""

    def __init__(self, leaves: Dict[str, torch.Tensor], children: Dict[str, nn.Module]):
        super().__init__()
        for name, t in leaves.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        for name, m in children.items():
            self.add_module(name, m)

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# -- norms ----------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


# -- rotary embeddings -----------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Half-rotation RoPE (the head dimension split in two halves, not
    interleaved lanes).  x: (..., T, H, D); positions: (..., T)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)             # (D/2,)
    angles = positions[..., :, None].float() * freqs               # (..., T, D/2)
    cos = torch.cos(angles)[..., None, :]                           # (..., T, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- losses -----------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token CE with optional z-loss; logits (..., V), labels (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return torch.mean(loss)


def _ce_chunk(hidden, w, labels, base: int, m, lse_acc, label_logit):
    """One vocabulary chunk of the streaming CE: the running max, the
    rescaled sum of exponentials and the label's logit where it falls in
    [base, base + width)."""
    logits = (hidden @ w).float()                                   # (B, T, width)
    width = w.shape[-1]
    m_new = torch.maximum(m, logits.amax(-1))
    lse_acc = lse_acc * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
    in_chunk = (labels >= base) & (labels < base + width)
    local = torch.clamp(labels - base, 0, width - 1)
    picked = torch.gather(logits, -1, local[..., None])[..., 0]
    return m_new, lse_acc, torch.where(in_chunk, picked, label_logit)


def chunked_softmax_cross_entropy(hidden: torch.Tensor, head_w: torch.Tensor,
                                  labels: torch.Tensor, *, chunk: int = 8192,
                                  z_loss: float = 0.0) -> torch.Tensor:
    """Streaming CE: never materialises the (B, T, V) logits.

    Walks the head's vocabulary in chunks, carrying the running max, the
    log-sum-exp and the label logit, as the JAX package's scan does; the last
    chunk is as wide as what is left of V (``repro`` pads it and masks the
    pad to -1e30, which adds nothing).  Under autograd each chunk is
    recomputed in the backward pass (``torch.utils.checkpoint``), so the
    backward holds one chunk's logits at a time too.  hidden (B, T, D),
    head_w (D, V)."""
    B, T, _ = hidden.shape
    V = head_w.shape[-1]
    labels = labels.long()
    m = torch.full((B, T), float("-inf"), device=hidden.device)
    lse_acc = torch.zeros((B, T), device=hidden.device)
    label_logit = torch.zeros((B, T), device=hidden.device)
    grad = torch.is_grad_enabled() and (hidden.requires_grad or head_w.requires_grad)
    for base in range(0, V, chunk):
        w = head_w[:, base:base + chunk]
        if grad:
            m, lse_acc, label_logit = checkpoint(_ce_chunk, hidden, w, labels, base, m,
                                                 lse_acc, label_logit, use_reentrant=False)
        else:
            m, lse_acc, label_logit = _ce_chunk(hidden, w, labels, base, m, lse_acc,
                                                label_logit)
    lse = m + torch.log(torch.clamp_min(lse_acc, 1e-30))
    loss = lse - label_logit
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return torch.mean(loss)


# -- §Perf levers ----------------------------------------------------------------


class _BF16Boundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_boundary(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; casts the cotangent to bf16 in backward.

    Placed at residual-stream block boundaries it forces the backward's
    cotangents (fp32 out of the fp32-internal norms and softmax) down to
    bf16 — in the JAX package, the bytes of the tensor-parallel backward
    all-reduces — at the cost of bf16 gradient precision across blocks."""
    return _BF16Boundary.apply(x)
