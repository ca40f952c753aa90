"""Gradient compression — the accumulator's sparse/auto modes for training
(port of :mod:`repro.optim.compression`).

STEP §5.2 transfers sparse vectors as (index, value) pairs when beneficial.
For gradients (dense but compressible) the production analogue is top-k
sparsification with **error feedback** (the residual is carried to the next
step so the update remains unbiased in the limit), wrapped around the
accumulator.  On the card the selection runs the ``topk_compress`` kernel
(its argmax body below :data:`~repro_torch.kernels.topk_compress.ops.BITONIC_MIN_K`
keys a block, its radix body from there) and each densify the
``sparse_scatter_add`` kernel; a CPU tensor takes their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.accumulator import AccumMode, accumulate
from repro_torch.core.sparse import blocked_topk_sparsify, densify
from repro_torch.device import resolve_device


class EFState(NamedTuple):
    """Error-feedback residual, same structure as the (packed) gradient."""

    residual: torch.Tensor


def ef_init(flat_len: int, device=None) -> EFState:
    """A zero residual on ``device`` (``None``: the card)."""
    return EFState(torch.zeros((flat_len,), dtype=torch.float32,
                               device=resolve_device(device)))


def compressed_accumulate(flat_grad: torch.Tensor, ef: EFState, axis, k: int,
                          mode: AccumMode | str = AccumMode.SPARSE):
    """Top-k + error feedback around the accumulator.

    Returns (global_sum_of_compressed, new_ef).  Inside a mesh position.
    Each intermediate is dropped once used, so a position holds at most
    three gradient-sized vectors besides its input."""
    mode = AccumMode(mode)
    corrected = flat_grad.float() + ef.residual
    idx, vals = blocked_topk_sparsify(corrected, k)
    sent = densify(idx, vals, corrected.shape[0])
    del idx, vals
    new_residual = corrected - sent
    del corrected
    total = accumulate(sent, axis, mode, k=k)
    return total, EFState(new_residual)


def compression_ratio(flat_len: int, k: int) -> float:
    """Wire-bytes ratio of the pairs representation vs dense (paper's rule)."""
    return (2.0 * k) / float(flat_len)
