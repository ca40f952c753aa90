"""Least time of a pagerank iteration on a Graph500 Kronecker graph, and of
its kernels, on one H100.  Frozen with the benchmark: later changes to the
program are measured against these counts.

An iteration has to read each edge once, at 4 bytes (one 32-bit vertex id,
the least any edge layout reads: the other end is implied by the order),
and per vertex its rank and out-degree and write its new rank (12 bytes).
The accumulator's dense round (kernel G, ``accumulate_kernel``) reads the
threads' N credit rows of V float32 and writes one.
"""

from stepbench import peaks


def _sizes(cfg: dict):
    g = cfg["graph"]
    return 1 << int(g["scale"]), int(g["edgefactor"]) << int(g["scale"])


def iteration_least_s(cfg: dict) -> float:
    v, e = _sizes(cfg)
    return (4 * e + 12 * v) / peaks.HBM_BYTES_PER_S


def kernel_least_s(cfg: dict) -> dict:
    v, _ = _sizes(cfg)
    s = cfg["session"]
    rows = int(s["n_nodes"]) * int(s["threads_per_node"])
    return {"accumulate_kernel": (rows + 1) * v * 4 / peaks.HBM_BYTES_PER_S}
