"""The SSD scan kernel's wrapper (``csrc/ssd_scan.cu``).

Port of :mod:`repro.kernels.ssd_scan.kernel`.  One launch walks, for every
(batch, head), the chunks of xbar (b, T, H, P), log-decay a (b, T, H) and
B/C (b, T, G, N) in order and writes y (b, T, H, P); head h reads group
h // (H // G) of B/C in place.  :func:`ssd_scan_bh` is the TPU kernel's
(BH, T, ·) form, the same launch with H = G = 1.

A CPU tensor takes the plain version (:func:`ssd_scan_plain`, the chunked
algorithm); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import check_chunks, ssd_scan_plain

MAX_SHARED_BYTES = 227 * 1024  # a CTA's shared memory on Hopper
STRIP = 32                     # score rows per strip (csrc/ssd_scan.cu)

launches = build.LaunchCounter("ssd_scan")

_SIGNATURES = {"ssd_scan_f32": (build.PTR, build.PTR, build.PTR, build.PTR, build.PTR,
                                build.INT, build.INT, build.INT, build.INT, build.INT,
                                build.INT, build.INT, build.PTR)}


def smem_bytes(chunk: int, P: int, N: int) -> int:
    """Shared memory of one CTA (csrc/ssd_scan.cu: a chunk's xbar, B
    transposed (rows padded by one float) and C, the state, one strip of
    scores, and cum with its two exponentials)."""
    return 4 * (chunk * P + N * (chunk + 1) + chunk * N + N * P + STRIP * chunk
                + 3 * chunk)


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
    if any(t.dtype != torch.float32 for t in (xbar, a, B, C)):
        raise TypeError("the ssd_scan kernel takes float32 inputs, got "
                        f"{[str(t.dtype) for t in (xbar, a, B, C)]}")
    if smem_bytes(chunk, P, N) > MAX_SHARED_BYTES:
        raise ValueError(f"the ssd_scan kernel keeps one chunk and the state in shared "
                         f"memory; chunk={chunk}, P={P}, N={N} exceeds {MAX_SHARED_BYTES} "
                         "bytes")
    y = torch.empty_like(xbar, memory_format=torch.contiguous_format)
    if y.numel() == 0:
        return y
    xbar, a, B, C = xbar.contiguous(), a.contiguous(), B.contiguous(), C.contiguous()
    lib = build.library("ssd_scan", _SIGNATURES)
    with torch.cuda.device(xbar.device):
        code = lib.ssd_scan_f32(xbar.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
                                y.data_ptr(), b, T, H, G, P, N, chunk,
                                build.stream_of(xbar))
    build.check(lib, "ssd_scan_f32", code)
    launches.add()
    return y


def ssd_scan_bh(x: torch.Tensor, a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor, *,
                chunk: int) -> torch.Tensor:
    """x (BH, T, P), a (BH, T), bm/cm (BH, T, N) → y (BH, T, P).  T % chunk == 0."""
    return ssd_scan(x[:, :, None], a[:, :, None], bm[:, :, None], cm[:, :, None],
                    chunk=chunk)[:, :, 0]
