"""Model-layout entry point of the SSD scan.

Port of :mod:`repro.kernels.ssd_scan.ops`: the log-decay a = dt·(−exp
A_log) in fp32 and x̄ = x·dt in x's dtype, then the scan.  The CUDA kernel
reads B/C per head group where the JAX wrapper repeats them over the heads
(the plain version a CPU tensor runs still repeats them).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_scan


def ssd(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, *, chunk: int = 128):
    """Same contract as ``ssd_chunked``: returns (y, final_state=None).

    x (b,T,H,P), dt (b,T,H), A_log (H,), B/C (b,T,G,N).
    """
    a = (dt * (-torch.exp(A_log))[None, None, :]).float()
    xbar = x * dt[..., None].to(x.dtype)
    return ssd_scan(xbar, a, B, C, chunk=chunk), None
