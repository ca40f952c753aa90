"""Logistic regression's margins and residuals over a CSR design matrix.

For each row i of one thread's rows of x, ``r_i = y_i - sigmoid(z_i)``
with ``z_i = sum_j x[i, j] * theta[j]``: the products in fp64 (exact), the
row's sum in fp64 rounded once to fp32, the sigmoid and the residual in
fp32.  The JAX package has no kernel for it (its logreg takes a dense x);
on the card ``csrc/logreg_margin.cu`` does it in one launch, a warp a row
in the rows' own order.  :func:`margin_residuals` takes CUDA tensors only:
on the CPU ``analytics/logreg.py`` calls :func:`margin_residuals_plain`,
which the kernel is held against.
"""

from __future__ import annotations

import torch

from repro_torch.data.csr import CSRMatrix
from repro_torch.kernels import build

launches = build.LaunchCounter("logreg_margin")

_SIGNATURES = {"logreg_margin": (build.PTR, build.PTR, build.PTR, build.PTR, build.PTR,
                                 build.LONG, build.PTR, build.PTR)}


def margin_residuals_plain(x: CSRMatrix, y: torch.Tensor, theta: torch.Tensor,
                           rows: torch.Tensor = None) -> torch.Tensor:
    """The plain PyTorch version: the products in fp64 added into each row
    by ``index_add_`` (``rows``: :meth:`CSRMatrix.row_ids`, computed here
    where not given), rounded once to fp32."""
    rows = x.row_ids() if rows is None else rows
    terms = theta[x.indices.long()].double() * x.values.double()
    z = torch.zeros(x.shape[0], dtype=torch.float64, device=theta.device).index_add_(
        0, rows, terms)
    return y - torch.sigmoid(z.float())


def _check(x: CSRMatrix, y: torch.Tensor, theta: torch.Tensor) -> None:
    n_rows, n_cols = x.shape
    if theta.dtype != torch.float32 or theta.shape != (n_cols,):
        raise TypeError(f"logreg_margin wants theta of shape ({n_cols},) float32, got "
                        f"{tuple(theta.shape)} {theta.dtype}")
    if y.dtype != torch.float32 or y.shape != (n_rows,):
        raise TypeError(f"logreg_margin wants y of shape ({n_rows},) float32, got "
                        f"{tuple(y.shape)} {y.dtype}")
    tensors = (x.indptr, x.indices, x.values, theta, y)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("logreg_margin takes contiguous tensors")
    if any(t.device != x.device for t in (theta, y)):
        raise ValueError(f"logreg_margin wants theta and y on x's device {x.device}")
    if not x.is_cuda:
        raise ValueError(f"logreg_margin runs on the card, not {x.device}: the CPU takes "
                         "margin_residuals_plain")


def margin_residuals(x: CSRMatrix, y: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """(rows,) float32 residuals ``y - sigmoid(x @ theta)`` of a CSR ``x``.
    One launch on the card."""
    _check(x, y, theta)
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if index != torch.cuda.current_device():   # switch devices only where needed
        with torch.cuda.device(index):
            return margin_residuals(x, y, theta)
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    lib = build.library("logreg_margin", _SIGNATURES)
    code = lib.logreg_margin(x.indptr.data_ptr(), x.indices.data_ptr(), x.values.data_ptr(),
                             theta.data_ptr(), y.data_ptr(), x.shape[0], out.data_ptr(),
                             torch.cuda.current_stream(index).cuda_stream)
    if code:
        build.check(lib, "logreg_margin", code)
    launches.add(int(x.shape[0] > 0))     # no rows, no launch
    return out
