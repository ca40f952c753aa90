"""Graph500 Kronecker graph, made on the device from a seed.

The Graph500 specification (3.0, section 3) draws each of the
``edgefactor * 2**scale`` edges independently: at each of ``scale`` levels
one quadrant of the adjacency matrix is chosen with the initiator's
probabilities A, B, C, D, which sets one bit of the source (the row) and
one of the destination (the column).  The vertex labels are then permuted
at random.  Self-loops and duplicate edges are kept, as the specification
keeps them.  The specification also shuffles the edge list; the edges here
are drawn independently of one another, so their order is already a random
one and no shuffle is made.

The edge list is int32 ``(E, 2)``, column 0 the source.  It is made in
blocks of edges, one uniform draw a level and an edge, so that what is
held beside the list stays a few hundred MB.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 25


def edge_count(scale: int, edgefactor: int) -> int:
    return edgefactor << scale


def make(cfg: dict, generator: torch.Generator, device: torch.device) -> dict:
    """``{"edges", "n_vertices"}`` of ``cfg["graph"]``, drawn from
    ``generator``."""
    g = cfg["graph"]
    scale, edgefactor = int(g["scale"]), int(g["edgefactor"])
    a, b, c, _ = (float(x) for x in g["initiator"])
    n_vertices = 1 << scale
    n_edges = edge_count(scale, edgefactor)
    edges = torch.empty((n_edges, 2), dtype=torch.int32, device=device)
    for lo in range(0, n_edges, BLOCK):
        n = min(BLOCK, n_edges - lo)
        src = torch.zeros(n, dtype=torch.int32, device=device)
        dst = torch.zeros(n, dtype=torch.int32, device=device)
        for level in range(scale):
            u = torch.rand(n, generator=generator, device=device)
            # quadrants: [0, a) top-left, [a, a+b) top-right,
            # [a+b, a+b+c) bottom-left, the rest bottom-right
            src_bit = u >= a + b
            dst_bit = (u >= a) & (u < a + b) | (u >= a + b + c)
            src |= src_bit.to(torch.int32) << level
            dst |= dst_bit.to(torch.int32) << level
        edges[lo:lo + n, 0] = src
        edges[lo:lo + n, 1] = dst
    if g.get("permute_labels", True):
        perm = torch.randperm(n_vertices, generator=generator, device=device,
                              dtype=torch.int64).to(torch.int32)
        for lo in range(0, n_edges, BLOCK):
            block = edges[lo:lo + BLOCK]
            block.copy_(perm[block.long()])
    return {"edges": edges, "n_vertices": n_vertices}
