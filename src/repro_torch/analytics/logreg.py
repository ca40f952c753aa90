"""Logistic regression — the paper's worked example (§4.5) on the Session facade.

Port of :mod:`repro.analytics.logreg`.  ``fit`` is a line-by-line port of the
paper's ``slave_proc``: every working thread keeps a local ``theta``,
computes the gradient over its partition (``LoadTrainPoint``), pushes it
through the shared accumulator (a synchronisation point), and applies the
accumulated global gradient from DSM.  The *same* ``thread_proc`` runs on
either substrate — ``backend="host"`` (DThreadPool + DAddAccumulator) or
``backend="spmd"`` (one STEP thread per mesh position) — selected at
``Session`` construction.

``x`` may be a :class:`~repro_torch.data.csr.CSRMatrix` (a sparse,
high-dimensional design matrix): ``Session.run`` then hands each thread its
rows of ``x`` with its labels.  A thread's gradient is ``X_t^T r`` with the
residuals ``r = y - sigmoid(X_t theta)``.  On the card the residuals take
one launch a round (:func:`~repro_torch.kernels.logreg_margin.ops.margin_residuals`,
a warp a row), and the gradient pagerank's binned credit kernel with a
value an edge: each thread sorts its nonzeros by feature once a job
(:func:`~repro_torch.kernels.pagerank_credits.ops.bin_edges`, edges from a
row to a feature) and sums ``r[row] * x[row, feature]`` per feature in
fp64 on chip (``binned_credits``), each rounded once to fp32.  A CPU slice
takes :func:`_csr_grad`, the plain version the kernels are held against.
A traced session records the job's ``job.setup``, ``session.join`` and
``job.teardown`` spans on the calling thread.  A dense ``x`` keeps its path,
its bits and the JAX package's spans.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import AccumMode, Session
from repro_torch.data.csr import CSRMatrix
from repro_torch.device import resolve_device, to_tensor
from repro_torch.kernels.logreg_margin.ops import margin_residuals, margin_residuals_plain
from repro_torch.kernels.pagerank_credits.ops import bin_edges, binned_credits


def _sigmoid(z):
    return 1.0 / (1.0 + torch.exp(-z))


def _local_grad(theta, x, y):
    """δ = Σ_p (y_p − σ(θᵀx_p))·x_p over this thread's mini-batch."""
    pred = _sigmoid(x @ theta)
    return (y - pred) @ x


def _csr_grad(theta, xs: CSRMatrix, ys, rows):
    """The plain ``X_t^T (y - sigmoid(X_t theta))`` of a CSR slice: the
    residuals as :func:`margin_residuals_plain` makes them, the terms
    ``r[row] * x`` in fp64 added by feature, rounded once to fp32
    (``rows``: the slice's :meth:`~CSRMatrix.row_ids`)."""
    r = margin_residuals_plain(xs, ys, theta, rows)
    terms = r[rows].double() * xs.values.double()
    return torch.zeros(xs.shape[1], dtype=torch.float64, device=theta.device).index_add_(
        0, xs.indices.long(), terms).float()


def _sparse_local_grad(xs: CSRMatrix, ys):
    """This thread's gradient as a function of theta, after the set-up it
    needs once a job: on the card the slice binned by feature."""
    if xs.is_cuda:
        pairs = torch.empty((xs.nnz, 2), dtype=torch.int32, device=xs.device)
        pairs[:, 0] = xs.row_ids(torch.int32)
        pairs[:, 1] = xs.indices
        binned = bin_edges(pairs, xs.shape[1], values=xs.values, n_sources=xs.shape[0])
        del pairs

        def local(theta):
            return binned_credits(binned, margin_residuals(xs, ys, theta))
    else:
        rows = xs.row_ids()

        def local(theta):
            return _csr_grad(theta, xs, ys, rows)
    return local


def _no_span(cat: str, name: str):
    return contextlib.nullcontext()


def loss(theta, x, y) -> float:
    z = np.asarray(x, np.float32) @ np.asarray(theta, np.float32)
    p = np.clip(1.0 / (1.0 + np.exp(-z)), 1e-7, 1 - 1e-7)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def fit_reference(x, y, iters: int = 10, lr: float = 1e-3, device=None):
    """Single-thread oracle (same algorithm, no distribution)."""
    dev = resolve_device(device)
    xt, yt = to_tensor(x, dev), to_tensor(y, dev)
    theta = torch.zeros(xt.shape[1], dtype=torch.float32, device=dev)
    for _ in range(iters):
        theta = theta + lr * _local_grad(theta, xt, yt)
    return theta.cpu().numpy()


def fit(x, y, *, iters: int = 10, lr: float = 1e-3,
        mode: Optional[AccumMode | str] = None, k: Optional[int] = None,
        session: Optional[Session] = None, backend: str = "host",
        n_nodes: int = 2, threads_per_node: int = 2, mesh=None, device=None):
    """Paper §4.5 through the Table-1 facade; backend-agnostic.

    ``x`` is a dense (rows, d) array or a :class:`CSRMatrix`.
    ``mode="sparse"``/``"auto"`` compress the gradient to top-``k`` (index,
    value) pairs — ``k`` becomes the grad ref's declared budget.  Returns
    ``(theta, session)``.
    """
    sess = session or Session(backend=backend, n_nodes=n_nodes,
                              threads_per_node=threads_per_node, mesh=mesh,
                              device=device)
    d = x.shape[1]
    grad = sess.new_array("grad", (d,), sparse_k=k)
    sparse = isinstance(x, CSRMatrix)

    def thread_proc(ctx, xs, ys):
        if sparse:
            local_grad = _sparse_local_grad(xs, ys)
        else:
            def local_grad(theta):
                return _local_grad(theta, xs, ys)

        def step(theta):                              # one synchronous round
            with ctx.span("logreg.round"):            # app-round marker
                local = local_grad(theta)                 # lines 14–21
                total = grad.accumulate(local, mode=mode)  # line 22 (sync point)
                return theta + lr * total             # lines 23–24
        return ctx.iterate(step, torch.zeros(d, dtype=torch.float32,
                                             device=ctx.device), iters)

    # a dense x records the JAX package's spans alone
    span = sess.span if sparse else _no_span
    with span("job", "job.setup"):
        with span("job", "session.spawn"):
            sess.spawn(thread_proc, data=(x, y))
    with span("job", "session.join"):
        thetas = sess.join()
    with span("job", "job.teardown"):
        theta = thetas[0].cpu().numpy()
    return theta, sess


def fit_ssp(x, y, *, n_workers: int = 4, staleness: int = 1, iters: int = 10,
            lr: float = 1e-3, device=None):
    """Asynchronous SGD under Stale Synchronous Parallel (paper §7 / Petuum):
    workers ``inc`` the shared theta without a barrier, and the SSP clock
    blocks only a worker more than ``staleness`` ticks ahead of the slowest."""
    sess = Session(backend="host", n_nodes=n_workers, threads_per_node=1,
                   device=device)
    d = x.shape[1]
    theta = sess.def_global("theta", torch.zeros(d, dtype=torch.float32))
    clock = sess.ssp_clock(staleness)

    def worker(ctx, xs, ys):
        def step(_):
            with ctx.span("logreg.ssp_round"):
                g = _local_grad(theta.get(), xs, ys)   # possibly stale replica
                theta.inc(lr * g)                      # atomic DSM update
                clock.tick(ctx.tid)
                clock.wait(ctx.tid)                    # bounded staleness
            return _
        ctx.iterate(step, None, iters)

    sess.run(worker, data=(x, y), timeout=60)
    return theta.get().cpu().numpy(), clock
