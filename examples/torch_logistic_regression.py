"""Paper §4.5 end to end on the PyTorch port: logistic regression three
ways, one workload.

1. fit_reference        — single-thread oracle
2. fit(backend="host")  — the paper's DThread + DSM + accumulator program
3. fit(backend="spmd")  — the same thread_proc over mesh positions

All three produce the same parameters (the accumulator is exact): the STEP
programming model is a *semantics-preserving* distribution of the sequential
program, and the Session facade makes the substrate a constructor argument
instead of a rewrite.  Each host run prints the elements the accumulator put
on the wire and the branch its last round took.  On the card by default.

    PYTHONPATH=src python examples/torch_logistic_regression.py
    PYTHONPATH=src python examples/torch_logistic_regression.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.analytics import logreg
from repro_torch.core import AccumMode
from repro_torch.data import logreg_dataset


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    x, y, theta_true = logreg_dataset(n_rows=2000, n_features=64, seed=0)

    ref = logreg.fit_reference(x, y, iters=20, lr=1e-3, device=args.device)
    print(f"reference loss: {logreg.loss(ref, x, y):.4f}")

    for mode in (AccumMode.GATHER_ALL, AccumMode.REDUCE_SCATTER, AccumMode.AUTO):
        theta, sess = logreg.fit(x, y, backend="host", n_nodes=2, threads_per_node=2,
                                 iters=20, lr=1e-3, mode=mode, device=args.device)
        drift = float(np.max(np.abs(theta - ref)))
        branch = sess.accumulator("grad").last_mode.value
        print(f"host[{mode.value:>14s}] loss {logreg.loss(theta, x, y):.4f} "
              f"drift {drift:.2e} wire {sess.wire_traffic():>8d} elems "
              f"branch {branch}")

    spmd, sess = logreg.fit(x, y, backend="spmd", iters=20, lr=1e-3, device=args.device)
    print(f"spmd[{sess.backend.n_threads} threads] loss: "
          f"{logreg.loss(spmd, x, y):.4f} "
          f"drift {float(np.max(np.abs(spmd - ref))):.2e} "
          f"wire {sess.wire_traffic():>8d} elems")


if __name__ == "__main__":
    main()
