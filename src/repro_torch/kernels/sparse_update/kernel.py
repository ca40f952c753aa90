"""Sparse scatter-add — the receive side of the accumulator's sparse mode.

Port of :mod:`repro.kernels.sparse_update.kernel`: (idx, vals) → a dense
(out_len,) vector, duplicates summed in fp32 and cast to vals' dtype
(float32 or bfloat16), indices outside [0, out_len) dropped.  A (T, P) pair
matrix is one row per thread, applied in row order.

On the card ``csrc/scatter_add.cu`` launches once per call, whatever the
number of rows: one cooperative kernel zeroes the sum, adds each row's
pairs with fp32 atomics, a grid barrier between one row and the next, and
casts a bf16 result; a CPU tensor takes
:func:`~repro_torch.kernels.sparse_update.ref.sparse_scatter_add_plain`.
Where each row's indices are unique apart from ``(0, +0.0)`` padding — the
accumulator's pairs — the kernel is bit-exact with the plain version.  With
arbitrary duplicates inside one row the atomics add in a varying order, and
the kernel holds to the plain version within rtol 1e-5, atol 1e-6 (the
tolerance of the JAX package's kernel test, ``tests/test_kernels.py``).

:func:`repro_torch.core.sparse.densify` calls
:func:`sparse_scatter_add_unchecked`, which skips the public entry's
checks and, on the current device, the device switch: at the
accumulator's small rounds a call's host cost is what decides this kernel
against one ``index_add_``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sparse_update.ref import pair_rows, sparse_scatter_add_plain

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
INDEX_KINDS = {torch.int32: 0, torch.int64: 1}

launches = build.LaunchCounter("sparse_scatter_add")

_SIGNATURES = {"sparse_scatter_add_rows": (build.INT, build.INT, build.PTR, build.PTR,
                                           build.INT, build.LONG, build.LONG, build.PTR,
                                           build.PTR, build.PTR)}


def sparse_scatter_add(idx: torch.Tensor, vals: torch.Tensor, out_len: int, *,
                       block_v: int = 1024) -> torch.Tensor:
    """Dense (out_len,) sum of the pairs (idx, vals), each (M,) or (T, P).

    ``block_v`` is accepted for parity with ``repro`` and does not change the
    result.  On the card this launches the CUDA kernel once (counted once,
    whatever T is); on the CPU it runs the plain version."""
    if out_len < 0 or block_v < 1:
        raise ValueError(f"out_len must be >= 0 and block_v >= 1, got {out_len}, {block_v}")
    pair_rows(idx, vals)
    if idx.device != vals.device:
        raise ValueError(f"idx on {idx.device} and vals on {vals.device}")
    if vals.device.type == "cpu":
        return sparse_scatter_add_plain(idx, vals, out_len)
    if vals.device.type != "cuda":
        raise ValueError(f"sparse_scatter_add runs on cpu or cuda, not {vals.device}")
    if vals.dtype not in DTYPES:
        raise TypeError(f"the sparse_scatter_add kernel takes float32 or bfloat16 values, "
                        f"got {vals.dtype}")
    if idx.dtype not in INDEX_KINDS:
        raise TypeError(f"the sparse_scatter_add kernel takes int32 or int64 indices, "
                        f"got {idx.dtype}")
    return sparse_scatter_add_unchecked(idx, vals, out_len)


def sparse_scatter_add_unchecked(idx: torch.Tensor, vals: torch.Tensor,
                                 out_len: int) -> torch.Tensor:
    """:func:`sparse_scatter_add` of pairs that the caller guarantees are one
    shape, (M,) or (T, P), on one device, with int32 or int64 indices and
    float32 or bfloat16 values, and ``out_len >= 0``, without checking them:
    :func:`repro_torch.core.sparse.densify`'s entry.  CPU pairs run the plain
    version."""
    if not vals.is_cuda:
        return sparse_scatter_add_plain(idx, vals, out_len)
    index = vals.get_device()
    if index != torch.cuda.current_device():   # switch devices only where needed
        with torch.cuda.device(index):
            return sparse_scatter_add_unchecked(idx, vals, out_len)
    rows, m = (1, idx.shape[0]) if idx.ndim == 1 else idx.shape
    if not idx.is_contiguous():
        idx = idx.contiguous()
    if not vals.is_contiguous():
        vals = vals.contiguous()
    acc = torch.empty(out_len, dtype=torch.float32, device=vals.device)
    out = acc if vals.dtype == torch.float32 else torch.empty(
        out_len, dtype=vals.dtype, device=vals.device)
    if out_len == 0:
        return out
    lib = build.library("scatter_add", _SIGNATURES)
    # the stream asked for by device index: torch's shortest public path to it
    code = lib.sparse_scatter_add_rows(
        INDEX_KINDS[idx.dtype], DTYPES[vals.dtype], idx.data_ptr(), vals.data_ptr(), rows, m,
        out_len, acc.data_ptr(), None if out is acc else out.data_ptr(),
        torch.cuda.current_stream(index).cuda_stream)
    if code:
        build.check(lib, "sparse_scatter_add_rows", code)
    launches.add()
    return out
