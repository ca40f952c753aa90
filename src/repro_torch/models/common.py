"""Shared model building blocks: init, norms, RoPE.

Port of :mod:`repro.models.common`.  Parameters are tensors held in
``nn.ParameterDict``\\ s whose keys are ``repro``'s leaf names, so a
parameter tree carries across by name (:mod:`repro_torch.models.convert`).
Every init draws from an explicit :class:`torch.Generator` on the device the
tensor is made on.  Losses, ``bf16_boundary`` and the chunked CE wait for the
training slice.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn


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
    Serving holds weights fixed, so no gradient is tracked (the training
    slice turns it on)."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


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
