"""Sparse scatter-add — the receive side of the accumulator's sparse mode.

Port of :mod:`repro.kernels.sparse_update.kernel`: (idx, vals) → a dense
(out_len,) vector, duplicates summed in fp32 and cast to vals' dtype
(float32 or bfloat16), indices outside [0, out_len) dropped.  A (T, P) pair
matrix is one row per thread, applied in row order.

On the card ``csrc/scatter_add.cu`` launches once per row, in stream order,
adding with fp32 atomics; a CPU tensor takes
:func:`~repro_torch.kernels.sparse_update.ref.sparse_scatter_add_plain`.
Where each row's indices are unique apart from ``(0, +0.0)`` padding — the
accumulator's pairs — the kernel is bit-exact with the plain version.  With
arbitrary duplicates inside one row the atomics add in a varying order, and
the kernel holds to the plain version within rtol 1e-5, atol 1e-6 (the
tolerance of the JAX package's kernel test, ``tests/test_kernels.py``).
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
    result.  On the card this launches the CUDA kernel once per row (each
    launch counted); on the CPU it runs the plain version."""
    if out_len < 0 or block_v < 1:
        raise ValueError(f"out_len must be >= 0 and block_v >= 1, got {out_len}, {block_v}")
    idx_rows, val_rows = pair_rows(idx, vals)
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
    idx_rows, val_rows = idx_rows.contiguous(), val_rows.contiguous()
    rows, m = idx_rows.shape
    acc = torch.empty(out_len, dtype=torch.float32, device=vals.device)
    out = acc if vals.dtype == torch.float32 else torch.empty(
        out_len, dtype=vals.dtype, device=vals.device)
    if out_len == 0:
        return out
    lib = build.library("scatter_add", _SIGNATURES)
    with torch.cuda.device(vals.device):
        code = lib.sparse_scatter_add_rows(
            INDEX_KINDS[idx.dtype], DTYPES[vals.dtype], idx_rows.data_ptr(),
            val_rows.data_ptr(), rows, m, out_len, acc.data_ptr(),
            None if out is acc else out.data_ptr(), build.stream_of(vals))
    build.check(lib, "sparse_scatter_add_rows", code)
    launches.add(rows)
    return out
