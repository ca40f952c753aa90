"""Entry point of the blocked accumulator (port of
:mod:`repro.kernels.accumulate.ops`)."""

from __future__ import annotations

from repro_torch.kernels.accumulate.kernel import accumulate_blocked
from repro_torch.kernels.accumulate.ref import Rows


def accumulate(x: Rows, *, block_v: int = 1024):
    """x (N, V), or N same-shape 1-D rows, → (V,): the fp32 column sum."""
    return accumulate_blocked(x, block_v=block_v)
