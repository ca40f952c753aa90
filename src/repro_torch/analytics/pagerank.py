"""PageRank (paper §6.7) on the Session facade: edge-partitioned credits.

Port of :mod:`repro.analytics.pagerank`.  Each thread owns a slice of the
edge list; per iteration it computes the credit vector its sources send along
their out-edges and accumulates it (the paper: "communication cost is
proportional to the number of vertices").  The accumulator's ``sparse`` /
``auto`` modes engage when the per-thread credit vector is sparse — graphs
with concentrated out-degrees.  The out-degree vector rides along replicated
(``broadcast=``).  One ``thread_proc`` serves the host and the SPMD backend.

The credits' scatter adds millions of terms into a few popular vertices.
In fp32 (as the JAX package sums them) the order of the adds then moves the
result by percents, and ``index_add_`` on the card adds atomically, in an
order that changes from run to run.  The port sums the credits in fp64 and
rounds once to fp32: the atomic order then moves a credit by at most one
fp32 ulp, so runs on the card repeat to within one ulp.  On graphs small
enough that fp32's own rounding stays below it, the port agrees with the JAX
package to the app tolerance.  (A sort-based
``index_put_(accumulate=True)`` repeats to the bit but adds each vertex's
duplicates serially, far too slow where a few vertices take millions of
edges.)

On the card each thread sorts its slice once a job into an int32 copy
grouped by destination bin (:func:`~repro_torch.kernels.pagerank_credits.ops.bin_edges`)
and each round sums its credits in one launch, in fp64 on chip, from one
gather of ``ranks / out_deg`` an edge (``binned_credits``): no E-sized
temporary, and an atomic in device memory only where a bin split across
CTAs merges its pieces.  A CPU slice takes
:func:`_credits` over its edges as they are, the plain version the kernel
is held against.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import AccumMode, Session
from repro_torch.device import resolve_device, to_tensor
from repro_torch.kernels.pagerank_credits.ops import bin_edges, binned_credits

DAMPING = 0.85


def _credits(src, dst, ranks, out_deg, n_vertices):
    """Credit vector contributed by this thread's edges."""
    w = (ranks[src] / out_deg[src]).to(torch.float64)
    return torch.zeros(n_vertices, dtype=torch.float64,
                       device=ranks.device).index_add_(0, dst, w).to(torch.float32)


def _out_degree(src, n_vertices):
    deg = torch.zeros(n_vertices, dtype=torch.float32, device=src.device)
    deg.index_add_(0, src, torch.ones(src.shape[0], device=src.device))
    return deg.clamp_min(1.0)


def fit_reference(edges, n_vertices: int, iters: int = 10, device=None):
    """Single-thread oracle (same algorithm, no distribution)."""
    e = to_tensor(edges, resolve_device(device)).long()
    src, dst = e[:, 0], e[:, 1]
    out_deg = _out_degree(src, n_vertices)
    ranks = torch.full((n_vertices,), 1.0 / n_vertices, device=e.device)
    for _ in range(iters):
        credits = _credits(src, dst, ranks, out_deg, n_vertices)
        ranks = (1 - DAMPING) / n_vertices + DAMPING * credits
    return ranks.cpu().numpy()


def fit(edges, n_vertices: int, *, iters: int = 10,
        mode: Optional[AccumMode | str] = AccumMode.AUTO, k: Optional[int] = None,
        session: Optional[Session] = None, backend: str = "host",
        n_nodes: int = 2, threads_per_node: int = 2, mesh=None, device=None):
    """Credit accumulation through the Table-1 facade; backend-agnostic.

    ``mode="auto"`` ships (index, value) pairs only on rounds where every
    thread's credit vector compresses losslessly under the budget ``k``
    (default ~V/4).  ``k`` becomes the credits ref's declared budget.
    A traced session records the job's ``job.setup``, ``session.join`` and
    ``job.teardown`` spans on the calling thread.  Returns ``(ranks, session)``.
    """
    sess = session or Session(backend=backend, n_nodes=n_nodes,
                              threads_per_node=threads_per_node, mesh=mesh,
                              device=device)

    def thread_proc(ctx, edges_loc, deg):
        if edges_loc.is_cuda:
            binned = bin_edges(edges_loc.contiguous(), n_vertices)

            def local_credits(r):
                return binned_credits(binned, r / deg)
        else:
            src, dst = edges_loc[:, 0].long(), edges_loc[:, 1].long()

            def local_credits(r):
                return _credits(src, dst, r, deg, n_vertices)

        def step(_):                       # the shared ranks carry the state
            with ctx.span("pagerank.round"):
                total = credits.accumulate(local_credits(ranks.get()), mode=mode)
                ranks.set((1 - DAMPING) / n_vertices + DAMPING * total)
            return _
        ctx.iterate(step, None, iters)
        return None

    with sess.span("job", "job.setup"):
        edges_t = to_tensor(edges, sess.device)
        out_deg = _out_degree(edges_t[:, 0].long(), n_vertices)
        ranks = sess.def_global(
            "ranks", torch.full((n_vertices,), 1.0 / n_vertices, device=sess.device))
        credits = sess.new_array("credits", (n_vertices,), sparse_k=k)
        with sess.span("job", "session.spawn"):
            sess.spawn(thread_proc, data=(edges_t,), broadcast=(out_deg,))
    with sess.span("job", "session.join"):
        sess.join()
    with sess.span("job", "job.teardown"):
        out = ranks.get().cpu().numpy()
    return out, sess
