"""Fused sparsify→scatter-add — the accumulator's SPARSE reduce in one launch.

Port of :mod:`repro.kernels.accumulate.fused_scatter`.  x (N, V) → (V,): for
each V-block of ``block_eff``, each row keeps its ``per_block`` largest |x|
((|x| desc, index asc); lanes past V never; ``per_block >= block_eff`` keeps
every valid entry), the rest of the row is zero, and rows 0..N-1 are summed
as a left fold in fp32 and cast to x's dtype.  That is the association order
of scatter-adding the threads' pairs in thread order, so the result is
bit-exact with the compress→densify→add path.

On the card one CUDA launch does it (``csrc/fused_scatter.cu``); a CPU tensor
takes :func:`fused_topk_scatter_plain`, which the kernel is held against.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bitonic import sort_desc, topk_keys

MAX_BLOCK = 1024  # one thread per column of a block

launches = build.LaunchCounter("fused_topk_scatter")

_SIGNATURES = {"fused_topk_scatter_f32": (build.PTR, build.PTR, build.INT, build.LONG,
                                          build.INT, build.INT, build.PTR)}


def fused_topk_scatter_plain(x: torch.Tensor, per_block: int,
                             block_eff: int) -> torch.Tensor:
    """The plain PyTorch version: threshold keys by a sort, then the fold."""
    n, v = x.shape
    block_eff = min(block_eff, v)
    nblocks = -(-v // block_eff)
    xp = torch.nn.functional.pad(x.float(), (0, nblocks * block_eff - v))
    xp = xp.reshape(n, nblocks, block_eff)
    valid = (torch.arange(nblocks * block_eff, device=x.device) < v)
    valid = valid.reshape(1, nblocks, block_eff)
    if per_block < block_eff:
        keys = topk_keys(xp, valid)
        thr = sort_desc(keys)[..., per_block - 1:per_block]
        sel = valid & (keys >= thr)
    else:
        sel = valid
    contrib = torch.where(sel, xp, torch.zeros((), device=x.device))
    acc = contrib[0]
    for t in range(1, n):                     # left fold: the kernel's order
        acc = acc + contrib[t]
    return acc.reshape(-1)[:v].to(x.dtype)


def fused_topk_scatter(x: torch.Tensor, *, per_block: int,
                       block_eff: int) -> torch.Tensor:
    """Sum of each row's blocked top-``per_block`` entries of x (N, V).

    On the card this launches the CUDA kernel (float32 input, blocks of at
    most 1024); on the CPU it runs the plain version."""
    if x.ndim != 2:
        raise ValueError(f"fused_topk_scatter wants (N, V), got shape {tuple(x.shape)}")
    if per_block < 1:
        raise ValueError(f"per_block must be >= 1, got {per_block}")
    if x.shape[0] < 1:
        raise ValueError("fused_topk_scatter needs at least one row")
    if x.device.type == "cpu":
        return fused_topk_scatter_plain(x, per_block, block_eff)
    if x.device.type != "cuda":
        raise ValueError(f"fused_topk_scatter runs on cpu or cuda, not {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the fused_topk_scatter kernel takes float32, got {x.dtype}")
    n, v = x.shape
    block_eff = min(block_eff, v)
    if block_eff > MAX_BLOCK:
        raise ValueError(f"the fused_topk_scatter kernel takes blocks of at most "
                         f"{MAX_BLOCK}, got {block_eff}")
    x = x.contiguous()
    out = torch.empty(v, dtype=x.dtype, device=x.device)
    lib = build.library("fused_scatter", _SIGNATURES)
    with torch.cuda.device(x.device):
        code = lib.fused_topk_scatter_f32(x.data_ptr(), out.data_ptr(), n, v,
                                          block_eff, per_block, build.stream_of(x))
    build.check(lib, "fused_topk_scatter_f32", code)
    launches.add()
    return out
