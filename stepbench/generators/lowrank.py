"""A dense non-negative matrix of low rank plus noise, made on the device.

``R = |P| |Q| + noise * |N|`` with P ``(users, rank)``, Q ``(rank, items)``
and N of standard normals: the construction of the JAX package's
``nmf_dataset``, drawn here with a ``torch.Generator`` on the device and
written in blocks of rows, so that only R and one block are ever held.
"""

from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 14


def make(cfg: dict, generator: torch.Generator, device: torch.device) -> dict:
    """``{"r"}``: the fp32 matrix of ``cfg["matrix"]``, drawn from
    ``generator``."""
    m = cfg["matrix"]
    rows, cols, rank = int(m["users"]), int(m["items"]), int(m["data_rank"])
    noise = float(m["noise"])
    p = torch.randn(rows, rank, generator=generator, device=device).abs_()
    q = torch.randn(rank, cols, generator=generator, device=device).abs_()
    r = torch.empty(rows, cols, dtype=torch.float32, device=device)
    for lo in range(0, rows, BLOCK_ROWS):
        hi = min(rows, lo + BLOCK_ROWS)
        block = r[lo:hi]
        torch.matmul(p[lo:hi], q, out=block)
        block.add_(torch.randn(hi - lo, cols, generator=generator,
                               device=device).abs_(), alpha=noise)
    return {"r": r}
