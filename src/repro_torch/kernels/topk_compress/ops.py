"""Per-block top-k magnitude compression — the unfused sparse accumulate.

Port of :mod:`repro.kernels.topk_compress`: x (V,) → ``(idx, vals)``, each
of length ``nblocks * k_per_block``; per block of ``block_v`` entries, the
``k_per_block`` largest |x| in (|x| desc, index asc) order.  Lanes past V
and exhausted slots give ``(0, 0)``; a valid zero keeps its real index.

Two CUDA bodies compute it (``csrc/topk_compress.cu``, float32 or
bfloat16, any block size), element-wise identical, each named after the
``repro`` body it replaces: ``method="argmax"`` (each warp's top keys by a
bitonic network in registers, the warps' lists merged in shared memory;
segments of :data:`LIST_CAP` keys past it) and ``method="bitonic"`` (a
radix select of the block's k-th key, ``csrc/radix_select.cuh``, then a
bitonic sort of the k selected keys alone).  ``method=None`` takes bitonic
from :data:`BITONIC_MIN_K` on.  A CPU tensor takes
:func:`topk_compress_plain`, which both bodies are held against.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bitonic import key_pos, key_valid, sort_desc, topk_keys

# The crossover of the two bodies, carried over from the JAX package's CPU
# interpret-mode timing, so that the default picks the body repro picks.
# chip_smoke.py sweeps both bodies over k on the card (PERF.md §6).
BITONIC_MIN_K = 65
METHODS = ("argmax", "bitonic")
LIST_CAP = 256  # the argmax body's list of a warp at most (kListCap in csrc/topk_compress.cu)
SELECT_STATIC_SMEM = 4096  # bounds the bitonic body's radix::Rows<1> (static_assert there)

launches = {m: build.LaunchCounter(f"topk_compress_{m}") for m in METHODS}

_SIGNATURES = {"topk_compress": (build.INT, build.PTR, build.PTR, build.PTR, build.LONG,
                                 build.INT, build.INT, build.INT, build.PTR, build.PTR)}


def work_bytes(block_v: int, k_per_block: int, method: str) -> int:
    """One CTA's working set where it may outgrow shared memory: none for
    the argmax body (its warps' lists of at most :data:`LIST_CAP` keys, 64
    KB at 32 warps, always fit), the bitonic body's k selected 64-bit keys,
    padded to a power of two for the sort (while they are no more than the
    CTA's threads, at most 1,024, they are sorted in registers and take
    twice that, 16 KB at most)."""
    if method == "argmax":
        return 0
    return 8 * (1 << (k_per_block - 1).bit_length())


def topk_compress_plain(x: torch.Tensor, k_per_block: int, block_v: int):
    """The plain PyTorch version: a sort of packed keys per block."""
    v = x.shape[0]
    block_v = min(block_v, v)
    nblocks = -(-v // block_v)
    xp = torch.nn.functional.pad(x, (0, nblocks * block_v - v))
    xp = xp.reshape(nblocks, block_v)
    flat_pos = torch.arange(nblocks * block_v, device=x.device)
    valid = (flat_pos < v).reshape(nblocks, block_v)
    top = sort_desc(topk_keys(xp, valid))[:, :k_per_block]
    pos = key_pos(top)
    ok = key_valid(top)
    base = (torch.arange(nblocks, device=x.device) * block_v)[:, None]
    idx = torch.where(ok, base + pos, 0).to(torch.int32).reshape(-1)
    vals = torch.where(ok, torch.gather(xp, 1, pos), torch.zeros((), dtype=x.dtype,
                                                                 device=x.device))
    return idx, vals.reshape(-1)


def topk_compress(x: torch.Tensor, *, k_per_block: int, block_v: int = 1024,
                  method: str | None = None):
    """``(idx int32, vals)`` of the blocked top-k of a 1-D ``x``.

    On the card this launches the CUDA body ``method`` picks (float32 or
    bfloat16, any block size); on the CPU it runs the plain version."""
    if x.ndim != 1:
        raise ValueError(f"topk_compress wants a 1-D vector, got shape {tuple(x.shape)}")
    if k_per_block < 1:
        raise ValueError(f"k_per_block must be >= 1, got {k_per_block}")
    block_v = min(block_v, x.shape[0])
    if k_per_block > block_v:
        raise ValueError(
            f"k_per_block={k_per_block} exceeds the block size {block_v} — "
            "nothing left to select")
    if method is None:
        method = "bitonic" if k_per_block >= BITONIC_MIN_K else "argmax"
    if method not in METHODS:
        raise ValueError(f"method must be argmax|bitonic, got {method!r}")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return topk_compress_plain(x, k_per_block, block_v)
        raise ValueError(f"topk_compress runs on cpu or cuda, not {x.device}")
    dtype = build.dtype_code("topk_compress", x)
    index = x.get_device()
    if index != torch.cuda.current_device():   # switch devices only where needed
        with torch.cuda.device(index):
            return topk_compress(x, k_per_block=k_per_block, block_v=block_v, method=method)
    x = x.contiguous()
    v = x.shape[0]
    nblocks = -(-v // block_v)
    idx = torch.empty(nblocks * k_per_block, dtype=torch.int32, device=x.device)
    vals = torch.empty(nblocks * k_per_block, dtype=x.dtype, device=x.device)
    bitonic = method == "bitonic"
    work = (build.scratch(work_bytes(block_v, k_per_block, method), nblocks, x.device,
                          SELECT_STATIC_SMEM) if bitonic else None)
    lib = build.library("topk_compress", _SIGNATURES)
    # the stream asked for by device index: torch's shortest public path to it
    code = lib.topk_compress(dtype, x.data_ptr(), idx.data_ptr(), vals.data_ptr(), v,
                             block_v, k_per_block, int(bitonic),
                             None if work is None else work.data_ptr(),
                             torch.cuda.current_stream(index).cuda_stream)
    if code:
        build.check(lib, "topk_compress", code)
    launches[method].add()
    return idx, vals
