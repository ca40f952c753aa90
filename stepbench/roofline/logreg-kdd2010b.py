"""Least time of a logistic-regression iteration over a sparse design
matrix (full-batch gradient descent, rows split over the threads), and of
its kernels, on one H100.  Frozen with the benchmark: later changes to the
program are measured against these counts.

An iteration has two products over the nonzeros, the margins X theta and
the gradient X^T r, and each has to read every nonzero once at 8 bytes (a
32-bit feature id and a 32-bit value; the row is implied by the order):
16 bytes a nonzero.  Per row it reads the label and writes and reads the
residual (12 bytes); per feature it reads theta for the margins, writes
the gradient, and reads it and theta and writes theta in the update (20
bytes).  Theta's gathers by the margins are not counted beyond that read.

A thread's call of the margin kernel (``margin_kernel``) reads its rows'
nonzeros (8 B each) and each row's label and writes its residual (8 B a
row); of the gradient's binned kernel (``credits_kernel``) it reads the
nonzeros (8 B each) and each row's residual (4 B) and writes the whole
gradient (4 B a feature).  A call's least time is that of the mean slice.
The accumulator's dense round (kernel G, ``accumulate_kernel``) reads the
threads' N gradients of ``features`` float32 and writes one, as in
pagerank's counts.
"""

from stepbench import peaks


def _sizes(cfg: dict):
    m = cfg["matrix"]
    return int(m["rows"]), int(m["features"]), int(m["nnz"])


def _threads(cfg: dict) -> int:
    s = cfg["session"]
    return int(s["n_nodes"]) * int(s["threads_per_node"])


def iteration_bytes(cfg: dict) -> float:
    rows, features, nnz = _sizes(cfg)
    return 16.0 * nnz + 12.0 * rows + 20.0 * features


def iteration_least_s(cfg: dict) -> float:
    return iteration_bytes(cfg) / peaks.HBM_BYTES_PER_S


def kernel_least_s(cfg: dict) -> dict:
    rows, features, nnz = _sizes(cfg)
    n = _threads(cfg)
    return {"margin_kernel": (8.0 * nnz + 8.0 * rows) / n / peaks.HBM_BYTES_PER_S,
            "credits_kernel": ((8.0 * nnz + 4.0 * rows) / n + 4.0 * features)
            / peaks.HBM_BYTES_PER_S,
            "accumulate_kernel": (n + 1) * features * 4.0 / peaks.HBM_BYTES_PER_S}
