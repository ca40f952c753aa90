"""Blocked N-vector accumulation — the DAddAccumulator's local combine.

Port of :mod:`repro.kernels.accumulate.kernel`: x (N, V) → (V,), the column
sum in fp32 cast back to x's dtype (float32 or bfloat16).  On the card one
CUDA launch (``csrc/accumulate.cu``) folds rows 0..N-1 in row order, so for
float32 it gives the bits of the left fold ``x_0 + x_1 + …``; a CPU tensor
takes :func:`~repro_torch.kernels.accumulate.ref.accumulate_plain`, which
the kernel is held against.

Besides the (N, V) tensor the wrapper takes N same-shape 1-D rows: the host
accumulator holds a round as separate tensors, and the kernel reads them
through a list of device pointers, without a stacked copy.  The accumulator
calls :func:`accumulate_rows_unchecked`, which skips the row checks (a
round's rows are one shape, dtype and device by construction) and, on the
current device, the device switch: a call's host cost is what decides this
kernel against one ``torch.sum``.
"""

from __future__ import annotations

from functools import reduce
from operator import or_
from typing import Sequence

import torch

from repro_torch.kernels import build
from repro_torch.kernels.accumulate.ref import Rows, accumulate_plain

MAX_ROW_POINTERS = 64   # rows passed by pointer (kMaxRows); more are stacked

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
    if dtype not in build.DTYPES:
        raise TypeError(f"the accumulate_blocked kernel takes float32 or bfloat16, got {dtype}")
    if isinstance(x, torch.Tensor):
        return _fold_stacked(x.contiguous())
    return accumulate_rows_unchecked(rows)


def accumulate_rows_unchecked(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """:func:`accumulate_blocked` of N 1-D rows that the caller guarantees
    are one shape, one dtype (float32 or bfloat16) and one device, without
    checking them: the accumulator's entry.  A CPU round runs the plain
    version."""
    first = rows[0]
    if not first.is_cuda:
        return accumulate_plain(rows)
    n = len(rows)
    if n > MAX_ROW_POINTERS:
        return _fold_stacked(torch.stack(rows))
    out = torch.empty_like(first)           # (V,): a 1-D tensor's dense layout
    v = out.numel()
    if v == 0:
        return out
    rows = [r.contiguous() for r in rows]   # alive until the launch is queued
    ptrs = [r.data_ptr() for r in rows]
    dst = out.data_ptr()
    vector = not reduce(or_, ptrs, dst) & 15
    return _launch((build.PTR * n)(*ptrs), None, 0, n, v, out, dst, vector)


def _fold_stacked(x: torch.Tensor) -> torch.Tensor:
    """The fold of a contiguous (N, V) tensor, read from its base pointer."""
    n, v = x.shape
    out = torch.empty(v, dtype=x.dtype, device=x.device)
    if v == 0:
        return out
    base, stride, dst = x.data_ptr(), v * x.element_size(), out.data_ptr()
    vector = not (base | stride | dst) & 15
    return _launch(None, base, stride, n, v, out, dst, vector)


def _launch(ptrs, base, stride: int, n: int, v: int, out: torch.Tensor, dst: int,
            vector: bool) -> torch.Tensor:
    index = out.get_device()
    if index != torch.cuda.current_device():   # switch devices only where needed
        with torch.cuda.device(index):
            return _launch(ptrs, base, stride, n, v, out, dst, vector)
    lib = build.library("accumulate", _SIGNATURES)
    # the stream asked for by device index: torch's shortest public path to it
    code = lib.accumulate_rows(build.DTYPES[out.dtype], ptrs, base, stride, n, v, dst, vector,
                               torch.cuda.current_stream(index).cuda_stream)
    if code:
        build.check(lib, "accumulate_rows", code)
    launches.add()
    return out
