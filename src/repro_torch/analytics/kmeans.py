"""K-means (paper §6.5) on the Session facade: Lloyd iterations, shared centers.

Port of :mod:`repro.analytics.kmeans`.  Per iteration, each thread assigns
its points to the nearest center (the ``kmeans_assign`` CUDA kernel with
``use_kernel=True``), builds per-cluster partial sums + counts, and ships
them through the accumulator — the shared centers in DSM are then
``sum / count``.  One ``thread_proc`` serves both the host backend
(DThreadPool + DAddAccumulator, the paper's programming model) and the SPMD
backend (one STEP thread per mesh position).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import AccumMode, Session
from repro_torch.device import resolve_device, to_tensor
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign, kmeans_assign_plain


def _partials(points, assign, k):
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(torch.float32)  # (n, k)
    sums = onehot.T @ points                                    # (k, d)
    counts = onehot.sum(0)                                      # (k,)
    return sums, counts


def inertia(points, centers, device=None) -> float:
    dev = resolve_device(device)
    _, d = kmeans_assign_plain(to_tensor(points, dev), to_tensor(centers, dev))
    return float(d.sum())


def fit_reference(x, k: int, iters: int = 10, seed: int = 0, device=None):
    """Single-thread oracle (same algorithm, no distribution)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    centers = to_tensor(x[rng.choice(x.shape[0], k, replace=False)], dev)
    xt = to_tensor(x, dev)
    for _ in range(iters):
        a, _ = kmeans_assign_plain(xt, centers)
        sums, counts = _partials(xt, a, k)
        centers = sums / counts[:, None].clamp_min(1.0)
    return centers.cpu().numpy()


def fit(x, k: int, *, iters: int = 10, seed: int = 0,
        mode: Optional[AccumMode | str] = None, use_kernel: bool = False,
        session: Optional[Session] = None, backend: str = "host",
        n_nodes: int = 2, threads_per_node: int = 2, mesh=None, device=None):
    """Lloyd iterations through the Table-1 facade; backend-agnostic.
    Returns ``(centers, session)``."""
    sess = session or Session(backend=backend, n_nodes=n_nodes,
                              threads_per_node=threads_per_node, mesh=mesh,
                              device=device)
    rng = np.random.default_rng(seed)
    d = x.shape[1]
    centers = sess.def_global("centers", x[rng.choice(x.shape[0], k, replace=False)])
    partials = sess.new_array("partials", (k * (d + 1),))

    assign_fn = kmeans_assign if use_kernel else kmeans_assign_plain

    def thread_proc(ctx, pts):
        def step(_):                       # the shared centers carry the state
            with ctx.span("kmeans.round"):
                a, _dist = assign_fn(pts, centers.get())
                sums, counts = _partials(pts, a, k)
                flat = partials.accumulate(
                    torch.cat([sums.reshape(-1), counts]), mode=mode)
                sums_g = flat[: k * d].reshape(k, d)
                counts_g = flat[k * d:]
                # §4.5 pattern: every thread re-derives the identical center update
                centers.set(sums_g / counts_g[:, None].clamp_min(1.0))
            return _
        ctx.iterate(step, None, iters)
        return None

    sess.run(thread_proc, data=(x,))
    return centers.get().cpu().numpy(), sess
