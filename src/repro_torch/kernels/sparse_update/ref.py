"""The plain version of the sparse scatter-add.

Port of :mod:`repro.kernels.sparse_update.ref`: (idx, vals) → a dense
(out_len,) vector with duplicate indices summed in fp32 and the result cast
to vals' dtype; indices outside [0, out_len) are dropped, as the TPU
kernel's ``inside`` mask drops them.  A (T, P) pair matrix is one row per
thread, applied in row order.  On the CPU ``index_add_`` adds sequentially,
so for float32 this is bit-exact with ``repro``'s oracle
``zeros.at[idx].add(vals)``.
"""

from __future__ import annotations

import torch


def pair_rows(idx: torch.Tensor, vals: torch.Tensor):
    """``(idx, vals)`` as (T, P): a 1-D pair set is one row."""
    if idx.shape != vals.shape or idx.ndim not in (1, 2):
        raise ValueError(f"scatter-add wants idx and vals of one shape, (M,) or (T, P); "
                         f"got {tuple(idx.shape)} and {tuple(vals.shape)}")
    if idx.ndim == 1:
        return idx.reshape(1, -1), vals.reshape(1, -1)
    return idx, vals


def sparse_scatter_add_plain(idx: torch.Tensor, vals: torch.Tensor,
                             out_len: int) -> torch.Tensor:
    """One ``index_add_`` per row, into fp32 zeros, in row order."""
    acc = torch.zeros(out_len, dtype=torch.float32, device=vals.device)
    for i, v in zip(*pair_rows(idx, vals)):
        inside = (i >= 0) & (i < out_len)
        acc.index_add_(0, i[inside].long(), v[inside].float())
    return acc.to(vals.dtype)
