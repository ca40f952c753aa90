"""Blocked N-vector accumulation — the DAddAccumulator's local combine.

Port of :mod:`repro.kernels.accumulate.kernel`: x (N, V) → (V,), the column
sum in fp32 cast back to x's dtype (float32 or bfloat16).  On the card one
CUDA launch (``csrc/accumulate.cu``) folds rows 0..N-1 in row order, so for
float32 it gives the bits of the left fold ``x_0 + x_1 + …``; a CPU tensor
takes :func:`~repro_torch.kernels.accumulate.ref.accumulate_plain`, which
the kernel is held against.

Besides the (N, V) tensor the wrapper takes N same-shape 1-D rows: the host
accumulator holds a round as separate tensors, and the kernel reads them
through a list of device pointers, without a stacked copy.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.accumulate.ref import Rows, accumulate_plain

MAX_ROW_POINTERS = 64   # rows passed by pointer (kMaxRows); more are stacked
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = build.LaunchCounter("accumulate_blocked")

_SIGNATURES = {"accumulate_rows": (build.INT, build.PTR, build.PTR, build.LONG, build.INT,
                                   build.LONG, build.PTR, build.INT, build.PTR)}


def _rows_of(x: Rows) -> list:
    """The rows of x (N, V) or of a sequence of 1-D rows, checked."""
    if isinstance(x, torch.Tensor):
        if x.ndim != 2:
            raise ValueError(f"accumulate_blocked wants (N, V), got shape {tuple(x.shape)}")
        rows = list(x)
    else:
        rows = list(x)
        if any(not isinstance(r, torch.Tensor) or r.ndim != 1 for r in rows):
            raise ValueError("accumulate_blocked wants (N, V) or a sequence of 1-D rows")
        first = rows[0] if rows else None
        if any(r.shape != first.shape or r.dtype != first.dtype or r.device != first.device
               for r in rows):
            raise ValueError("accumulate_blocked: the rows differ in shape, dtype or device")
    if not rows:
        raise ValueError("accumulate_blocked needs at least one row")
    return rows


def accumulate_blocked(x: Rows, *, block_v: int = 1024) -> torch.Tensor:
    """x (N, V), or N same-shape 1-D rows, → (V,): fp32 column sum in the
    rows' dtype.  ``block_v`` is accepted for parity with ``repro`` and does
    not change the result: each CUDA thread owns 16 bytes of columns.

    On the card this launches the CUDA kernel (float32 or bfloat16); on the
    CPU it runs the plain version."""
    if block_v < 1:
        raise ValueError(f"block_v must be >= 1, got {block_v}")
    rows = _rows_of(x)
    dev = rows[0].device
    if dev.type == "cpu":
        return accumulate_plain(x)
    if dev.type != "cuda":
        raise ValueError(f"accumulate_blocked runs on cpu or cuda, not {dev}")
    dtype = rows[0].dtype
    if dtype not in DTYPES:
        raise TypeError(f"the accumulate_blocked kernel takes float32 or bfloat16, got {dtype}")
    n, v = len(rows), rows[0].shape[0]
    out = torch.empty(v, dtype=dtype, device=dev)
    if v == 0:
        return out
    size = rows[0].element_size()
    if isinstance(x, torch.Tensor) or n > MAX_ROW_POINTERS:
        stacked = (x if isinstance(x, torch.Tensor) else torch.stack(rows)).contiguous()
        base, stride, ptrs = stacked.data_ptr(), v * size, None
        vector = base % 16 == 0 and stride % 16 == 0
    else:
        rows = [r.contiguous() for r in rows]
        base, stride = None, 0
        ptrs = (ctypes.c_void_p * n)(*[r.data_ptr() for r in rows])
        vector = all(r.data_ptr() % 16 == 0 for r in rows)
    vector = vector and out.data_ptr() % 16 == 0
    lib = build.library("accumulate", _SIGNATURES)
    with torch.cuda.device(dev):
        code = lib.accumulate_rows(DTYPES[dtype], ptrs, base, stride, n, v, out.data_ptr(),
                                   int(vector), build.stream_of(out))
    build.check(lib, "accumulate_rows", code)
    launches.add()
    return out
