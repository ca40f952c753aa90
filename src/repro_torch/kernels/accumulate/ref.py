"""The plain version of the blocked accumulator.

Port of :mod:`repro.kernels.accumulate.ref`: x (N, V) → (V,), summed in
fp32 and cast back to x's dtype.  The sum is the left fold over the rows,
``x_0 + x_1 + …`` in row order, which is the order the CUDA kernel adds in
— so for float32 the two agree bit for bit, and both agree with the host
accumulator's fold of a round in arrival order.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

Rows = Union[torch.Tensor, Sequence[torch.Tensor]]


def accumulate_plain(x: Rows) -> torch.Tensor:
    """Left fold over the rows of x (N, V), or over a sequence of
    same-shape 1-D rows, in fp32; cast once to the rows' dtype.  Always a
    new tensor, as the kernel's output is (never a view of row 0)."""
    acc = x[0].to(torch.float32, copy=True)
    for row in x[1:]:
        acc = acc + row.float()
    return acc.to(x[0].dtype)
