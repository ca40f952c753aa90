"""Plain PageRank, the reference the pagerank cells are judged by.

The semantics of the port's app, worked out again from the edge list alone:
ranks start at 1/V; each round every vertex sends ``rank / out_degree`` (the
out-degree clamped at 1, so a vertex without out-edges sends its rank to
no one) along each of its out-edges, and the new rank is
``(1 - d) / V + d * credits``.  Plain torch in blocks of edges; nothing of
the port is imported.  ``dtype`` is the precision of the ranks and of the
credit sums: float64 for the reference, float32 for the control.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 1 << 25


def out_degree(edges: torch.Tensor, n_vertices: int) -> torch.Tensor:
    """Out-degrees (int64, exact), counted in blocks of edges."""
    deg = torch.zeros(n_vertices, dtype=torch.int64, device=edges.device)
    for lo in range(0, edges.shape[0], BLOCK):
        deg += torch.bincount(edges[lo:lo + BLOCK, 0].long(), minlength=n_vertices)
    return deg


def ranks(edges: torch.Tensor, n_vertices: int, iters: int, damping: float,
          dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The ranks after ``iters`` rounds, in ``dtype``."""
    deg = out_degree(edges, n_vertices).clamp_min(1).to(dtype)
    r = torch.full((n_vertices,), 1.0 / n_vertices, dtype=dtype, device=edges.device)
    for _ in range(iters):
        w = r / deg
        credits = torch.zeros(n_vertices, dtype=dtype, device=edges.device)
        for lo in range(0, edges.shape[0], BLOCK):
            block = edges[lo:lo + BLOCK].long()
            credits.index_add_(0, block[:, 1], w[block[:, 0]])
        r = (1 - damping) / n_vertices + damping * credits
    return r


def rank_gap(got: np.ndarray, want: torch.Tensor) -> float:
    """The largest gap between a rank and the reference's, over the
    reference's rank (every rank is at least (1 - d) / V)."""
    got_t = torch.as_tensor(np.asarray(got)).to(want.device, torch.float64)
    return float(((got_t - want.to(torch.float64)).abs() / want.to(torch.float64)).max())
