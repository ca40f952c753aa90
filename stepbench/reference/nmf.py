"""Plain NMF by Lee and Seung's multiplicative updates, the reference the
nmf cells are judged by.

The semantics of the port's app: P and Q start from ``default_rng(seed)``
(P's ``(n, k)`` normals, then Q's ``(k, m)``, each made non-negative by
``abs`` and rounded to float32: a frozen copy of that stream), then each
round ``P <- P * (R Q^T) / (P (Q Q^T) + eps)`` and, with the new P,
``Q <- Q * (P^T R) / ((P^T P) Q + eps)``.  Plain torch over blocks of R's
rows; nothing of the port is imported.  ``dtype`` is the precision of the
products: float64 for the reference, float32 with TF32 products for the
control.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-9
BLOCK_ROWS = 1 << 14


def initial(n: int, m: int, k: int, seed: int):
    """The initial P ``(n, k)`` and Q ``(k, m)`` as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    p = np.abs(rng.normal(size=(n, k))).astype(np.float32)
    q = np.abs(rng.normal(size=(k, m))).astype(np.float32)
    return p, q


def factors(r: torch.Tensor, k: int, iters: int, seed: int,
            dtype: torch.dtype = torch.float64, tf32: bool = False):
    """P and Q after ``iters`` rounds, in ``dtype``."""
    n, m = r.shape
    p0, q0 = initial(n, m, k, seed)
    p = torch.from_numpy(p0).to(r.device, dtype)
    q = torch.from_numpy(q0).to(r.device, dtype)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for _ in range(iters):
            qqt = q @ q.T
            numer = torch.zeros(k, m, dtype=dtype, device=r.device)
            gram = torch.zeros(k, k, dtype=dtype, device=r.device)
            for lo in range(0, n, BLOCK_ROWS):
                rb = r[lo:lo + BLOCK_ROWS].to(dtype)
                pb = p[lo:lo + BLOCK_ROWS]
                pb = pb * (rb @ q.T) / (pb @ qqt + EPS)
                p[lo:lo + BLOCK_ROWS] = pb
                numer += pb.T @ rb
                gram += pb.T @ pb
            q = q * numer / (gram @ q + EPS)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return p, q


def gap(got: np.ndarray, want: torch.Tensor) -> float:
    """The largest gap between an entry and the reference's, over the
    reference's largest entry."""
    want64 = want.to(torch.float64)
    got_t = torch.as_tensor(np.asarray(got)).to(want.device, torch.float64)
    return float((got_t - want64).abs().max() / want64.abs().max())
