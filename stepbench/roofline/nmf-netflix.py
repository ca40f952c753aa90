"""Least time of an NMF iteration (Lee-Seung updates, rows of R split over
the threads) on one H100.  Frozen with the benchmark.

An iteration's products are ``R Q^T`` and ``P^T R`` (2nmk flops each), and
``P (Q Q^T)``, ``P^T P`` and ``(P^T P) Q`` with ``Q Q^T`` (4nk^2 + 4mk^2
together), at the chip's fastest float32-accurate rate (3xTF32); R has to
be read at least once (4nm bytes).  The larger of the two bounds.  The
accumulator's dense round reads rows of k(m + k) floats, which L2 holds,
so kernel G has no HBM roofline here.
"""

from stepbench import peaks


def iteration_flops(cfg: dict) -> float:
    n, m = int(cfg["matrix"]["users"]), int(cfg["matrix"]["items"])
    k = int(cfg["job"]["rank"])
    return 4.0 * n * m * k + 4.0 * n * k * k + 4.0 * m * k * k


def iteration_least_s(cfg: dict) -> float:
    n, m = int(cfg["matrix"]["users"]), int(cfg["matrix"]["items"])
    return max(iteration_flops(cfg) / peaks.FP32_ACCURATE_FLOPS,
               4.0 * n * m / peaks.HBM_BYTES_PER_S)


def kernel_least_s(cfg: dict) -> dict:
    return {}
