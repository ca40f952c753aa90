"""Per-block top-k magnitude compression — the unfused sparse accumulate.

Port of :mod:`repro.kernels.topk_compress`: x (V,) → ``(idx, vals)``, each
of length ``nblocks * k_per_block``; per block of ``block_v`` entries, the
``k_per_block`` largest |x| in (|x| desc, index asc) order.  Lanes past V
and exhausted slots give ``(0, 0)``; a valid zero keeps its real index.

Two CUDA bodies compute it (``csrc/topk_compress.cu``, float32 or
bfloat16, any block size), element-wise identical: ``method="argmax"`` (k
block-wide argmax rounds) and ``method="bitonic"`` (named after ``repro``'s
body: a radix select of the block's k-th key, ``csrc/radix_select.cuh``,
then a bitonic sort of the k selected keys alone).  ``method=None`` takes bitonic from
:data:`BITONIC_MIN_K` on.  A CPU tensor takes :func:`topk_compress_plain`,
which both bodies are held against.
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
ARGMAX_STATIC_SMEM = 256  # the argmax body's per-warp winners (csrc/topk_compress.cu)
SELECT_STATIC_SMEM = 4096  # bounds the bitonic body's radix::Rows<1> (static_assert there)

launches = {m: build.LaunchCounter(f"topk_compress_{m}") for m in METHODS}

_SIGNATURES = {"topk_compress": (build.INT, build.PTR, build.PTR, build.PTR, build.LONG,
                                 build.INT, build.INT, build.INT, build.PTR, build.PTR)}


def work_bytes(block_v: int, k_per_block: int, method: str) -> int:
    """One CTA's working set where it may outgrow shared memory: the argmax
    body's fp32 magnitudes of the block, or the bitonic body's k selected
    64-bit keys, padded to a power of two for the sort (while they are no
    more than the CTA's threads, at most 1,024, they are sorted in registers
    and take twice that, 16 KB at most)."""
    if method == "argmax":
        return 4 * block_v
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
    if x.device.type == "cpu":
        return topk_compress_plain(x, k_per_block, block_v)
    if x.device.type != "cuda":
        raise ValueError(f"topk_compress runs on cpu or cuda, not {x.device}")
    dtype = build.dtype_code("topk_compress", x)
    x = x.contiguous()
    v = x.shape[0]
    nblocks = -(-v // block_v)
    idx = torch.empty(nblocks * k_per_block, dtype=torch.int32, device=x.device)
    vals = torch.empty(nblocks * k_per_block, dtype=x.dtype, device=x.device)
    work = build.scratch(work_bytes(block_v, k_per_block, method), nblocks, x.device,
                         ARGMAX_STATIC_SMEM if method == "argmax" else SELECT_STATIC_SMEM)
    lib = build.library("topk_compress", _SIGNATURES)
    with torch.cuda.device(x.device):
        code = lib.topk_compress(dtype, x.data_ptr(), idx.data_ptr(), vals.data_ptr(), v,
                                 block_v, k_per_block, int(method == "bitonic"),
                                 None if work is None else work.data_ptr(),
                                 build.stream_of(x))
    build.check(lib, "topk_compress", code)
    launches[method].add()
    return idx, vals
