"""NMF (paper §6.6) on the Session facade: R ≈ P·Q, globally shared Q.

Port of :mod:`repro.analytics.nmf`.  Multiplicative updates (Lee–Seung).
With rows partitioned across threads, P's update is thread-local; Q's update
needs two global reductions — numer = PᵀR (k×m) and gram = PᵀP (k×k) —
which is precisely an accumulator workload: one round of k·m + k² floats.
Under ``mode="auto"`` that round is dense on every iteration, so it is
folded by the ``accumulate_blocked`` kernel.  The two products over R
(``R·Qᵀ`` in ``_update_p``, ``Pᵀ·R`` in ``_q_partials``), which the JAX
package leaves to XLA, run on the card as one hand-written 3xTF32 kernel
each (``kernels/nmf_products``: float32-accurate, on the tensor cores,
R streamed once); on the CPU they are ``torch.matmul``, and the small
products beside them are ``torch.matmul`` everywhere.  One
``thread_proc`` serves the host and the SPMD backend.

The initial P and Q are numpy's ``default_rng(seed)`` normals (``_init``).
Where the session's device is the card, ``fit`` draws the same numbers
there (``kernels/nmf_init``, bit for bit), so a job does not wait on one
host core for them; the CPU, and the oracle ``fit_reference``, keep numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import AccumMode, Session
from repro_torch.device import resolve_device, to_tensor
from repro_torch.kernels.nmf_init import ops as nmf_init
from repro_torch.kernels.nmf_products import ops as nmf_products

_EPS = 1e-9


def _update_p(p, q, r):
    """P ← P ⊙ (RQᵀ) / (PQQᵀ), in place on the two fresh (n, k) products:
    the same operations and bits as ``p * (r @ q.T) / (p @ (q @ q.T) +
    _EPS)`` with two of its four temporaries."""
    rqt = nmf_products.rqt(r, q) if r.is_cuda else r @ q.T
    return rqt.mul_(p).div_((p @ (q @ q.T)).add_(_EPS))


def _q_partials(p, r):
    numer = nmf_products.ptr(p, r) if r.is_cuda else p.T @ r
    return numer, p.T @ p              # numer (k,m), gram (k,k)


def _init(n: int, m: int, k: int, seed: int):
    """The initial P (n, k) and Q (k, m): the JAX package's stream, P then Q,
    so that trajectories match."""
    rng = np.random.default_rng(seed)
    p = np.abs(rng.normal(size=(n, k))).astype(np.float32)
    q = np.abs(rng.normal(size=(k, m))).astype(np.float32)
    return p, q


def _initial(sess: Session, n: int, m: int, k: int, seed: int):
    """``_init``'s P0 and Q0 on the session's device, and the card's done
    flag (None on the host).  On a CUDA device they are drawn there, always
    (``kernels/nmf_init``); the CPU draws with numpy."""
    if sess.device.type != "cuda":
        return (*_init(n, m, k, seed), None)
    return nmf_init.abs_normals(n, m, k, *nmf_init.seeded(seed), sess.device)


def frob_loss(r, p, q, device=None) -> float:
    """‖R − PQ‖²_F per row."""
    dev = resolve_device(device)
    rt, pt, qt = (to_tensor(a, dev) for a in (r, p, q))
    return float(torch.linalg.norm(rt - pt @ qt) ** 2 / rt.shape[0])


def fit_reference(r, k: int, iters: int = 10, seed: int = 0, device=None):
    """Single-thread oracle (same algorithm, no distribution)."""
    dev = resolve_device(device)
    p0, q0 = _init(r.shape[0], r.shape[1], k, seed)
    p, q, rt = to_tensor(p0, dev), to_tensor(q0, dev), to_tensor(r, dev)
    for _ in range(iters):
        p = _update_p(p, q, rt)
        numer, gram = _q_partials(p, rt)
        q = q * numer / (gram @ q + _EPS)
    return p.cpu().numpy(), q.cpu().numpy()


def fit(r, k: int, *, iters: int = 10, seed: int = 0,
        mode: Optional[AccumMode | str] = None,
        session: Optional[Session] = None, backend: str = "host",
        n_nodes: int = 2, threads_per_node: int = 2, mesh=None, device=None):
    """Lee–Seung updates through the Table-1 facade; backend-agnostic.

    A traced session records the job's ``job.setup`` (the draw of P0 and Q0,
    ``nmf.init``, inside), ``session.join`` and ``job.teardown`` spans on the
    calling thread.  On the card P0 and Q0 are drawn there (``_initial``);
    the tear-down, which waits for the card anyway, checks that the draw
    wrote every value.  Returns ``(p, q, session)``.
    """
    sess = session or Session(backend=backend, n_nodes=n_nodes,
                              threads_per_node=threads_per_node, mesh=mesh,
                              device=device)
    n, m = r.shape

    def thread_proc(ctx, r_loc, p_loc):
        def step(p):                        # thread-local P rides in the carry
            with ctx.span("nmf.round"):
                q = Q.get()
                p = _update_p(p, q, r_loc)
                numer, gram = _q_partials(p, r_loc)
                flat = q_partials.accumulate(
                    torch.cat([numer.reshape(-1), gram.reshape(-1)]), mode=mode)
                numer_g = flat[: k * m].reshape(k, m)
                gram_g = flat[k * m:].reshape(k, k)
                Q.set(q * numer_g / (gram_g @ q + _EPS))
            return p
        return ctx.iterate(step, p_loc, iters)

    with sess.span("job", "job.setup"):
        with sess.span("job", "nmf.init"):
            p_full0, q0, drawn = _initial(sess, n, m, k, seed)
        Q = sess.def_global("Q", q0)
        q_partials = sess.new_array("q_partials", (k * m + k * k,))
        with sess.span("job", "session.spawn"):
            sess.spawn(thread_proc, data=(r, p_full0))
    with sess.span("job", "session.join"):
        ps = sess.join()
    with sess.span("job", "job.teardown"):
        p_full = torch.cat([p.cpu() for p in ps]).numpy()
        q = Q.get().cpu().numpy()
        if drawn is not None and not int(drawn):
            raise RuntimeError("nmf: the card's draw of P0 and Q0 ran short of its stream")
    return p_full, q, sess
