"""The SSD scan kernel's wrapper (``csrc/ssd_scan.cu``).

Port of :mod:`repro.kernels.ssd_scan.kernel`.  One launch walks, for every
(batch, head), the chunks of xbar (b, T, H, P), log-decay a (b, T, H) and
B/C (b, T, G, N) in order and writes y (b, T, H, P); head h reads group
h // (H // G) of B/C in place.  :func:`ssd_scan_bh` is the TPU kernel's
(BH, T, ·) form, the same launch with H = G = 1.

xbar, B and C are float32 or bfloat16 (one dtype; a is float32, as
``ops.ssd`` makes it); y comes back in xbar's dtype, the state stays fp32.
Where one chunk does not fit a CTA's shared memory, the kernel runs it as
consecutive sub-chunks (:func:`sub_chunk`) with the state carried between
them: the same recurrence.

A CPU tensor takes the plain version (:func:`ssd_scan_plain`, the chunked
algorithm); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import check_chunks, ssd_scan_plain

STRIP = 32                     # score rows per strip (csrc/ssd_scan.cu)

launches = build.LaunchCounter("ssd_scan")

_SIGNATURES = {"ssd_scan": (build.INT, build.PTR, build.PTR, build.PTR, build.PTR, build.PTR,
                            build.INT, build.INT, build.INT, build.INT, build.INT,
                            build.INT, build.INT, build.PTR)}


def smem_bytes(chunk: int, P: int, N: int) -> int:
    """Shared memory of one CTA (csrc/ssd_scan.cu: a chunk's xbar, B
    transposed (rows padded by one float) and C, the state, one strip of
    scores, and cum with its two exponentials)."""
    return 4 * (chunk * P + N * (chunk + 1) + chunk * N + N * P + STRIP * chunk
                + 3 * chunk)


def sub_chunk(chunk: int, P: int, N: int) -> int:
    """The chunk the kernel walks: ``chunk`` itself where it fits a CTA's
    shared memory, else its largest divisor that does."""
    for q in range(chunk, 0, -1):
        if chunk % q == 0 and smem_bytes(q, P, N) <= build.MAX_SHARED_BYTES:
            return q
    raise ValueError(f"the ssd_scan kernel keeps the (N, P) state in shared memory; "
                     f"N={N}, P={P} leave no room for a chunk")


def ssd_scan(xbar: torch.Tensor, a: torch.Tensor, B: torch.Tensor, C: torch.Tensor, *,
             chunk: int) -> torch.Tensor:
    """y (b, T, H, P) of the SSD scan; the state starts at zero."""
    if xbar.ndim != 4 or a.ndim != 3 or B.ndim != 4 or C.shape != B.shape:
        raise ValueError(f"ssd_scan wants xbar (b,T,H,P), a (b,T,H), B/C (b,T,G,N); got "
                         f"{tuple(xbar.shape)}, {tuple(a.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, T, H, P = xbar.shape
    G, N = B.shape[2], B.shape[3]
    if a.shape != (b, T, H) or B.shape[:2] != (b, T) or H % G:
        raise ValueError(f"ssd_scan: a {tuple(a.shape)} and B {tuple(B.shape)} do not match "
                         f"xbar {tuple(xbar.shape)} (H must be a multiple of G)")
    check_chunks(T, chunk)
    if xbar.device.type == "cpu":
        return ssd_scan_plain(xbar, a, B, C, chunk)[0]
    devices = {t.device for t in (xbar, a, B, C)}
    if xbar.device.type != "cuda" or len(devices) != 1:
        raise ValueError(f"ssd_scan runs on cpu or cuda with every input on one device, "
                         f"got {sorted(map(str, devices))}")
    dtype = build.dtype_code("ssd_scan", xbar, B, C)
    if a.dtype != torch.float32:
        raise TypeError(f"the ssd_scan kernel takes a float32 log-decay a, got {a.dtype}")
    q = sub_chunk(chunk, P, N)
    y = torch.empty_like(xbar, memory_format=torch.contiguous_format)
    if y.numel() == 0:
        return y
    xbar, a, B, C = xbar.contiguous(), a.contiguous(), B.contiguous(), C.contiguous()
    lib = build.library("ssd_scan", _SIGNATURES)
    with torch.cuda.device(xbar.device):
        code = lib.ssd_scan(dtype, xbar.data_ptr(), a.data_ptr(), B.data_ptr(),
                            C.data_ptr(), y.data_ptr(), b, T, H, G, P, N, q,
                            build.stream_of(xbar))
    build.check(lib, "ssd_scan", code)
    launches.add()
    return y


def ssd_scan_bh(x: torch.Tensor, a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor, *,
                chunk: int) -> torch.Tensor:
    """x (BH, T, P), a (BH, T), bm/cm (BH, T, N) → y (BH, T, P).  T % chunk == 0."""
    return ssd_scan(x[:, :, None], a[:, :, None], bm[:, :, None], cm[:, :, None],
                    chunk=chunk)[:, :, 0]
