"""Logistic regression — the paper's worked example (§4.5) on the Session facade.

Port of :mod:`repro.analytics.logreg`.  ``fit`` is a line-by-line port of the
paper's ``slave_proc``: every working thread keeps a local ``theta``,
computes the gradient over its partition (``LoadTrainPoint``), pushes it
through the shared accumulator (a synchronisation point), and applies the
accumulated global gradient from DSM.  The *same* ``thread_proc`` runs on
either substrate — ``backend="host"`` (DThreadPool + DAddAccumulator) or
``backend="spmd"`` (one STEP thread per mesh position) — selected at
``Session`` construction.

``fit_threads`` / ``fit_spmd`` remain as deprecation shims over ``fit``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import AccumMode, Session
from repro_torch.core.dsm import GlobalStore
from repro_torch.core.session import SpmdBackend, deprecated_entry
from repro_torch.device import resolve_device, to_tensor


def _sigmoid(z):
    return 1.0 / (1.0 + torch.exp(-z))


def _local_grad(theta, x, y):
    """δ = Σ_p (y_p − σ(θᵀx_p))·x_p over this thread's mini-batch."""
    pred = _sigmoid(x @ theta)
    return (y - pred) @ x


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

    ``mode="sparse"``/``"auto"`` compress the gradient to top-``k`` (index,
    value) pairs — ``k`` becomes the grad ref's declared budget.  Returns
    ``(theta, session)``.
    """
    sess = session or Session(backend=backend, n_nodes=n_nodes,
                              threads_per_node=threads_per_node, mesh=mesh,
                              device=device)
    d = x.shape[1]
    grad = sess.new_array("grad", (d,), sparse_k=k)

    def thread_proc(ctx, xs, ys):
        def step(theta):                              # one synchronous round
            with ctx.span("logreg.round"):            # app-round marker
                local = _local_grad(theta, xs, ys)        # lines 14–21
                total = grad.accumulate(local, mode=mode)  # line 22 (sync point)
                return theta + lr * total             # lines 23–24
        return ctx.iterate(step, torch.zeros(d, dtype=torch.float32,
                                             device=ctx.device), iters)

    thetas = sess.run(thread_proc, data=(x, y))
    return thetas[0].cpu().numpy(), sess


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


# ---------------------------------------------------------------------------
# Deprecated pre-Session entry points
# ---------------------------------------------------------------------------


def fit_threads(x, y, *, n_nodes: int = 2, threads_per_node: int = 2,
                iters: int = 10, lr: float = 1e-3,
                mode: AccumMode | str = AccumMode.REDUCE_SCATTER,
                store: Optional[GlobalStore] = None, device=None):
    """Deprecated shim: ``fit(backend="host")`` with the old return tuple."""
    deprecated_entry("logreg.fit_threads", 'logreg.fit(backend="host")')
    sess = Session(backend="host", n_nodes=n_nodes,
                   threads_per_node=threads_per_node, store=store,
                   accum_mode=mode, device=device)
    theta, sess = fit(x, y, iters=iters, lr=lr, mode=mode, session=sess)
    return theta, sess.store, sess.accumulator("grad")


def fit_spmd(x, y, mesh, *, iters: int = 10, lr: float = 1e-3,
             mode: AccumMode | str = AccumMode.REDUCE_SCATTER, k: int = 0,
             device=None):
    """Deprecated shim: ``fit(backend="spmd")``."""
    deprecated_entry("logreg.fit_spmd", 'logreg.fit(backend="spmd")')
    sess = Session(backend=SpmdBackend(mesh=mesh), device=device)
    theta, _ = fit(x, y, iters=iters, lr=lr, mode=mode, k=k or None, session=sess)
    return theta
