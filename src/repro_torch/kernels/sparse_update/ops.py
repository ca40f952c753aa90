"""Entry point of the sparse scatter-add (port of
:mod:`repro.kernels.sparse_update.ops`)."""

from __future__ import annotations

import torch

from repro_torch.kernels.sparse_update.kernel import sparse_scatter_add


def scatter_add(idx: torch.Tensor, vals: torch.Tensor, *, out_len: int,
                block_v: int = 1024) -> torch.Tensor:
    """(idx, vals) of shape (M,) or (T, P) → dense (out_len,), duplicates
    summed in fp32, rows applied in row order."""
    return sparse_scatter_add(idx, vals, out_len, block_v=block_v)
