"""nmf's two products over R on the card: ``R·Qᵀ`` and ``Pᵀ·R``.

The JAX package leaves both to XLA (``src/repro/analytics/nmf.py``); in
float32 with TF32 off ``torch.matmul`` runs them as cuBLAS SGEMMs on the
FFMA pipes, at ~40% of the bound set by reading R.  ``csrc/nmf_products.cu``
runs them on the tensor cores in 3xTF32: each operand split into a TF32 big
half and a small remainder, three TF32 products summed in fp32, so the
result keeps float32's accuracy; R is streamed once a product and split in
registers, never copied.  :func:`rqt` and :func:`ptr` take CUDA tensors only
(one launch each); on the CPU ``analytics/nmf.py`` keeps ``torch.matmul``.

Operands are float32 matrices whose rows are contiguous (any row pitch, any
starting row: a thread's slice of R is a view).  An empty product launches
nothing.  ``Pᵀ·R`` sums its rows in a fixed order (split ranges added in
turn, no float atomics), so two calls give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = build.LaunchCounter("nmf_products")

_SIGNATURES = {
    "nmf_rqt": (build.PTR, build.LONG, build.LONG, build.LONG, build.PTR, build.LONG,
                build.LONG, build.PTR, build.PTR, build.PTR),
    "nmf_ptr": (build.PTR, build.LONG, build.LONG, build.LONG, build.PTR, build.LONG,
                build.LONG, build.PTR, build.PTR, build.PTR),
    "nmf_products_scratch": (build.INT, build.LONG, build.LONG, build.LONG),
}


def _check(fn: str, a: torch.Tensor, b: torch.Tensor, agree: bool, what: str) -> None:
    for t in (a, b):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise TypeError(f"{fn} takes 2-D float32 matrices, got {t.dtype} of shape "
                            f"{tuple(t.shape)}")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{fn} takes matrices whose rows are contiguous, got strides "
                             f"{t.stride()}")
    if not agree:
        raise ValueError(f"{fn}: {tuple(a.shape)} and {tuple(b.shape)} differ in {what}")
    if not a.is_cuda or a.device != b.device:
        raise ValueError(f"{fn} runs on the card, not {a.device} / {b.device}: the CPU "
                         "takes torch.matmul")


def _pitch(t: torch.Tensor) -> int:
    return t.stride(0) if t.shape[0] > 1 else max(t.shape[1], 1)


def _launch(fn: str, which: int, n: int, m: int, k: int, out: torch.Tensor,
            *args) -> torch.Tensor:
    """Launch ``fn`` on ``out``'s device with scratch for its split tiles
    (2 x 4 B a value of Q or P) and its sync ints; returns ``out``."""
    index = out.device.index if out.device.index is not None else torch.cuda.current_device()
    if index != torch.cuda.current_device():   # switch devices only where needed
        with torch.cuda.device(index):
            return _launch(fn, which, n, m, k, out, *args)
    lib = build.library("nmf_products", _SIGNATURES)
    lib.nmf_products_scratch.restype = ctypes.c_longlong
    scratch = torch.empty(lib.nmf_products_scratch(which, n, m, k), dtype=torch.uint8,
                          device=out.device)
    code = getattr(lib, fn)(*args, scratch.data_ptr(), out.data_ptr(),
                            torch.cuda.current_stream(index).cuda_stream)
    if code:
        build.check(lib, fn, code)
    launches.add()
    return out


def rqt(r: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``r @ q.T`` (n, k) of r (n, m) and q (k, m), float32, in one launch."""
    _check("nmf rqt", r, q, r.dim() == q.dim() == 2 and q.shape[1] == r.shape[1], "m")
    (n, m), k = r.shape, q.shape[0]
    if n == 0 or m == 0 or k == 0:
        return torch.zeros((n, k), dtype=torch.float32, device=r.device)
    out = torch.empty((n, k), dtype=torch.float32, device=r.device)
    return _launch("nmf_rqt", 0, n, m, k, out, r.data_ptr(), n, m, _pitch(r), q.data_ptr(), k,
                   _pitch(q))


def ptr(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``p.T @ r`` (k, m) of p (n, k) and r (n, m), float32, in one launch;
    two calls on the same inputs give the same bits."""
    _check("nmf ptr", p, r, p.dim() == r.dim() == 2 and p.shape[0] == r.shape[0], "n")
    (n, k), m = p.shape, r.shape[1]
    if n == 0 or m == 0 or k == 0:
        return torch.zeros((k, m), dtype=torch.float32, device=r.device)
    out = torch.empty((k, m), dtype=torch.float32, device=r.device)
    return _launch("nmf_ptr", 1, n, m, k, out, p.data_ptr(), n, k, _pitch(p), r.data_ptr(), m,
                   _pitch(r))
