"""Plain logistic regression by full-batch gradient descent over a CSR
design matrix, the reference the logreg cells are judged by.

The semantics of the port's app, worked out again from the matrix alone:
theta starts at 0, and each round every row's residual is ``r_i = y_i -
sigmoid(sum_j x_ij theta_j)`` and ``theta <- theta + lr * X^T r``.  Plain
torch, one thread: the margins and the gradient by ``index_add_`` over
blocks of whole rows.  ``dtype`` is the precision of every number:
float64 for the reference, float32 for the control.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 1 << 25          # nonzeros a block, about


def row_blocks(indptr: torch.Tensor, block: int = BLOCK):
    """``(lo, hi, a, b)``: rows ``[lo, hi)`` hold nonzeros ``[a, b)``; each
    block at most ``block`` nonzeros but where one row holds more."""
    n_rows = indptr.numel() - 1
    marks = torch.arange(block, int(indptr[-1]) + block, block, device=indptr.device)
    ends = torch.searchsorted(indptr, marks, right=True).sub_(1).tolist()
    lo = 0
    for hi in ends + [n_rows]:
        hi = min(max(hi, lo + 1), n_rows)
        if hi > lo:
            yield lo, hi, int(indptr[lo]), int(indptr[hi])
            lo = hi


def _block(indptr, indices, values, lo, hi, a, b, dtype):
    """Rows ``[lo, hi)``: each nonzero's row, column (int64) and value."""
    rows = torch.repeat_interleave(torch.arange(lo, hi, device=values.device),
                                   torch.diff(indptr[lo:hi + 1]), output_size=b - a)
    return rows, indices[a:b].long(), values[a:b].to(dtype)


def theta(indptr: torch.Tensor, indices: torch.Tensor, values: torch.Tensor, n_features: int,
          y: torch.Tensor, iters: int, lr: float,
          dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Theta after ``iters`` rounds, in ``dtype``."""
    dev = values.device
    blocks = list(row_blocks(indptr))
    th = torch.zeros(n_features, dtype=dtype, device=dev)
    yd = y.to(dtype)
    for _ in range(iters):
        z = torch.zeros(yd.numel(), dtype=dtype, device=dev)
        for blk in blocks:
            rows, cols, v = _block(indptr, indices, values, *blk, dtype)
            z.index_add_(0, rows, v * th[cols])
        r = yd - torch.sigmoid(z)
        g = torch.zeros(n_features, dtype=dtype, device=dev)
        for blk in blocks:
            rows, cols, v = _block(indptr, indices, values, *blk, dtype)
            g.index_add_(0, cols, r[rows] * v)
        th = th + lr * g
    return th


def theta_gap(got: np.ndarray, want: torch.Tensor) -> float:
    """The largest gap between an entry of theta and the reference's, over
    the reference's largest entry."""
    want64 = want.to(torch.float64)
    got_t = torch.as_tensor(np.asarray(got)).to(want.device, torch.float64)
    return float((got_t - want64).abs().max() / want64.abs().max())
