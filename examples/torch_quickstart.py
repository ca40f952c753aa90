"""Quickstart on the PyTorch port: the STEP stack through the Session facade.

One `Session` object is the whole Table-1 API: shared state is declared with
``def_global``/``new_array`` and handled via typed `SharedRef` handles
(``.get()/.set()/.inc()/.accumulate()``), threads are spawned with
``session.run``, and the *same* workload code executes on the host backend
(paper-faithful DThreads + blocking accumulator) or the SPMD backend (mesh
positions as threads on one device) — pick one at ``Session(backend=...)``.
Per-thread loops are written with ``ctx.iterate(step, carry, iters)``.  The
script declares shared state, runs a tiny ``ctx.iterate`` program and the
paper's worked example (distributed multi-threaded logistic regression) on
both backends, then trains a tiny LM end to end through the trainer.  On
the card by default.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.analytics import logreg
from repro_torch.core import AccumMode, Session
from repro_torch.data import logreg_dataset
from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--lm-steps", type=int, default=10)
    args = ap.parse_args(argv)

    # 1. the Table-1 facade: DSM declaration through handles (paper §4.1)
    sess = Session(backend="host", n_nodes=2, threads_per_node=2, device=args.device)
    step_size = sess.def_global("step_size", 1e-3)
    grad = sess.new_array("grad", (32,))
    print(f"DSM declared: {sess.names()}, grad addr=0x{grad.address:x}, "
          f"step_size={float(step_size.get()):g}")

    # 1b. the iteration engine: one logical loop over synchronous rounds
    total = sess.new_array("total", ())

    def count_rounds(ctx):
        one = torch.ones((), device=ctx.device)
        return ctx.iterate(lambda c: c + total.accumulate(one),
                           torch.zeros((), device=ctx.device), 5)

    per_thread = sess.run(count_rounds)
    print(f"ctx.iterate: 5 rounds x {sess.backend.n_threads} threads -> "
          f"carry {float(per_thread[0]):g} per thread")

    # 2. the paper's §4.5 example on BOTH backends — same thread_proc
    x, y, _ = logreg_dataset(n_rows=800, n_features=32, seed=0)
    theta, hsess = logreg.fit(x, y, backend="host", n_nodes=2, threads_per_node=2,
                              iters=15, lr=1e-3, mode=AccumMode.REDUCE_SCATTER,
                              device=args.device)
    print(f"logreg[host] loss: {logreg.loss(theta, x, y):.4f} "
          f"(accumulator wire traffic: {hsess.wire_traffic()} elements, "
          f"(N+1)·V·iters = {(4 + 1) * 32 * 15})")
    theta_s, _ = logreg.fit(x, y, backend="spmd", iters=15, lr=1e-3, device=args.device)
    print(f"logreg[spmd] loss: {logreg.loss(theta_s, x, y):.4f} "
          f"drift vs host {float(np.max(np.abs(theta_s - theta))):.2e}")

    # 3. a tiny LM through the trainer
    losses = train("qwen3-1.7b", smoke=True, steps=args.lm_steps, batch=4, seq=64,
                   device=args.device)
    print(f"LM train: loss {losses[0]:.3f} → {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
