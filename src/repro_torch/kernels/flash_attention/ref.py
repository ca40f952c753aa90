"""The plain version of the flash attention kernel: full softmax attention."""

from __future__ import annotations

import math

import torch


def attention_bhsd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (BH, T, d), k (BH, S, d), v (BH, S, dv) → (BH, T, dv) in q's dtype.

    Scores in fp32 scaled by 1/√d; under ``causal`` a key after query
    position ``q_offset + t`` scores -1e30.  On the card the products run in
    full fp32 only while TF32 matmul is off (PyTorch's default)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    if causal:
        T, S = q.shape[1], k.shape[1]
        tpos = q_offset + torch.arange(T, device=q.device)
        mask = tpos[:, None] >= torch.arange(S, device=q.device)[None, :]
        s = s.masked_fill(~mask[None], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bts,bsd->btd", p, v.float()).to(q.dtype)
