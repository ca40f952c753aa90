"""Row partitioning of the host backend (the paper's ``LoadTrainPoint``).

The prefetching LM pipeline of :mod:`repro.data.pipeline` waits for the LM
slice; the Session needs only :func:`partition_rows`, which must give every
tid the same rows as the JAX package does.
"""

from __future__ import annotations


def partition_rows(n_rows: int, tid: int, n_threads: int):
    """The paper's ``LoadTrainPoint`` — thread tid's contiguous row range."""
    per = n_rows // n_threads
    extra = n_rows % n_threads
    start = tid * per + min(tid, extra)
    stop = start + per + (1 if tid < extra else 0)
    return start, stop
