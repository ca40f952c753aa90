"""The SSD scan kernel's wrapper (``csrc/ssd_scan.cu``).

Port of :mod:`repro.kernels.ssd_scan.kernel`.  One launch takes xbar (b, T,
H, P), log-decay a (b, T, H) and B/C (b, T, G, N) and writes y (b, T, H, P);
head h reads group h // (H // G) of B/C in place.  Every (batch, head,
chunk) is a work item of its own; the fp32 state passes from one chunk to
the next through a device scratch of two slots per (batch, head), and a
ticket counter with one count per (batch, head) orders the hand-off.  The
wrapper allocates both and zeroes the counter and the counts on every call
(so a CUDA graph that replays the call starts from zero too).
:func:`ssd_scan_bh` is the TPU kernel's (BH, T, ·) form, the same launch
with H = G = 1.

xbar, B and C are float32 or bfloat16 (one dtype; a is float32, as
``ops.ssd`` makes it); y comes back in xbar's dtype, the state stays fp32.
Where one chunk's tiles do not fit a CTA's shared memory, the kernel runs it
as consecutive sub-chunks (:func:`sub_chunk`), each an item of the chain:
the same recurrence.

A CPU tensor takes the plain version (:func:`ssd_scan_plain`, the chunked
algorithm); a CUDA tensor launches the kernel or raises; meta tensors (the
dry run's shapes, no values) run the plain version for shapes and operation
counts only; any other device raises.  Neither is
differentiable: ``repro``'s Pallas kernel has no backward, so a call
recorded for a gradient gets an output whose backward raises
(:func:`~repro_torch.kernels.build.forward_only`), on the card and on the
CPU alike.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import check_chunks, ssd_scan_plain

launches = build.LaunchCounter("ssd_scan")
NO_BACKWARD = ("ssd_scan has no backward: repro's Pallas kernel defines none, so the "
               "port's kernel defines none either; train with ssd_impl='chunked'")

_SIGNATURES = {"ssd_scan": (build.INT, build.PTR, build.PTR, build.PTR, build.PTR, build.PTR,
                            build.INT, build.INT, build.INT, build.INT, build.INT,
                            build.INT, build.INT, build.PTR, build.PTR, build.PTR),
               "ssd_scan_smem_bytes": (build.INT, build.INT, build.INT)}


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def smem_bytes(chunk: int, P: int, N: int) -> int:
    """Shared memory of one CTA (csrc/ssd_scan.cu, smem_floats): a chunk's
    xbar, B and C with rows to a multiple of 16 and N, P to multiples of 32,
    the previous state, four warps' partial sums of 16 x 64 y, cum as two
    floats with its two exponentials, and 32 floats for the scan's fp64 warp
    sums and the ticket."""
    q, n, p = _round_up(chunk, 16), _round_up(N, 32), _round_up(P, 32)
    return 4 * (q * p + 2 * q * n + n * p + 4 * 16 * 64 + 4 * q + 32)


def sub_chunk(chunk: int, P: int, N: int) -> int:
    """The chunk the kernel walks: ``chunk`` itself where it fits a CTA's
    shared memory, else its largest divisor that does."""
    for q in range(chunk, 0, -1):
        if chunk % q == 0 and smem_bytes(q, P, N) <= build.MAX_SHARED_BYTES:
            return q
    raise ValueError(f"the ssd_scan kernel keeps a chunk and the (N, P) state in shared memory; "
                     f"N={N}, P={P} leave no room for a chunk")


def ssd_scan(xbar: torch.Tensor, a: torch.Tensor, B: torch.Tensor, C: torch.Tensor, *,
             chunk: int) -> torch.Tensor:
    """y (b, T, H, P) of the SSD scan; the state starts at zero.  Not
    differentiable (its backward raises)."""
    if build.differentiated(xbar, a, B, C):
        return build.forward_only(NO_BACKWARD, lambda *t: ssd_scan(*t, chunk=chunk),
                                  xbar, a, B, C)
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
    if devices == {torch.device("meta")}:
        # shapes only (the dry run): nothing runs, so the plain version's
        # ops stand in
        return ssd_scan_plain(xbar, a, B, C, chunk)[0]
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
    # the ticket, then each (batch, head)'s count of published states: zero
    # on every call; two state slots per (batch, head), N and P to 32
    sync = torch.zeros(1 + b * H, dtype=torch.int32, device=xbar.device)
    states = torch.empty(b * H * 2 * _round_up(N, 32) * _round_up(P, 32) if T > q else 1,
                         dtype=torch.float32, device=xbar.device)
    lib = build.library("ssd_scan", _SIGNATURES)
    with torch.cuda.device(xbar.device):
        code = lib.ssd_scan(dtype, xbar.data_ptr(), a.data_ptr(), B.data_ptr(),
                            C.data_ptr(), y.data_ptr(), b, T, H, G, P, N, q,
                            states.data_ptr(), sync.data_ptr(), build.stream_of(xbar))
    build.check(lib, "ssd_scan", code)
    launches.add()
    return y


def ssd_scan_bh(x: torch.Tensor, a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor, *,
                chunk: int) -> torch.Tensor:
    """x (BH, T, P), a (BH, T), bm/cm (BH, T, N) → y (BH, T, P).  T % chunk == 0."""
    return ssd_scan(x[:, :, None], a[:, :, None], bm[:, :, None], cm[:, :, None],
                    chunk=chunk)[:, :, 0]
