"""A sparse design matrix in compressed sparse row form, split by rows.

``Session.run(data=(x, y))`` hands each thread a contiguous block of rows
of every ``data=`` array (the paper's ``LoadTrainPoint``): both backends
cut an array with ``a[lo:hi]`` on its ``shape[0]``.  A design matrix kept
as its list of nonzeros would be cut mid-row there, and out of step with
its labels.  :class:`CSRMatrix` is cut by rows instead: ``x[lo:hi]`` is rows
``lo`` to ``hi - 1``, its row pointers rebased to 0 (a new vector of
``hi - lo + 1``) and its column ids and values views of the parent's,
narrowed without a copy.  Finding where the rows start reads two row
pointers on the host, so a slice on the card waits for the work queued
before it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class CSRMatrix:
    """``shape`` (rows, n_cols): row i's nonzeros are ``indices[e]`` (the
    column) and ``values[e]`` for ``e`` in ``[indptr[i], indptr[i + 1])``.
    ``indptr`` (rows + 1,) int64 from 0, ``indices`` int32, ``values``
    float32, all on one device."""

    indptr: torch.Tensor
    indices: torch.Tensor
    values: torch.Tensor
    n_cols: int

    def __post_init__(self):
        if self.indptr.dtype != torch.int64 or self.indptr.ndim != 1 or self.indptr.numel() < 1:
            raise TypeError("CSRMatrix wants indptr (rows + 1,) int64")
        if self.indices.dtype != torch.int32 or self.values.dtype != torch.float32:
            raise TypeError(f"CSRMatrix wants int32 indices and float32 values, got "
                            f"{self.indices.dtype} and {self.values.dtype}")
        if self.indices.ndim != 1 or self.indices.shape != self.values.shape:
            raise ValueError(f"CSRMatrix wants indices and values of one length, got "
                             f"{tuple(self.indices.shape)} and {tuple(self.values.shape)}")
        if not self.indptr.device == self.indices.device == self.values.device:
            raise ValueError("CSRMatrix wants its three tensors on one device")
        if self.n_cols < 0:
            raise ValueError(f"CSRMatrix wants n_cols >= 0, got {self.n_cols}")

    @property
    def shape(self) -> tuple:
        return (self.indptr.numel() - 1, self.n_cols)

    @property
    def nnz(self) -> int:
        return self.indices.numel()

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def is_cuda(self) -> bool:
        return self.values.is_cuda

    def __getitem__(self, rows: slice) -> "CSRMatrix":
        if not isinstance(rows, slice) or rows.step not in (None, 1):
            raise TypeError("a CSRMatrix is cut by a contiguous slice of rows")
        lo, hi, _ = rows.indices(self.shape[0])
        hi = max(lo, hi)
        a, b = self.indptr[[lo, hi]].tolist()
        return CSRMatrix(self.indptr[lo:hi + 1] - a, self.indices[a:b], self.values[a:b],
                         self.n_cols)

    def to(self, device) -> "CSRMatrix":
        """The matrix on ``device`` (itself where it is there already)."""
        device = torch.device(device)
        if self.device.type == device.type and device.index in (None, self.device.index):
            return self
        return CSRMatrix(self.indptr.to(device), self.indices.to(device),
                         self.values.to(device), self.n_cols)

    def row_ids(self, dtype: torch.dtype = torch.int64) -> torch.Tensor:
        """(nnz,) the row of each nonzero."""
        counts = torch.diff(self.indptr)
        return torch.repeat_interleave(
            torch.arange(self.shape[0], dtype=dtype, device=self.device), counts,
            output_size=self.nnz)
