"""NMF cells: the port's ``nmf.fit`` over a matrix the benchmark made on the
device, judged by ``reference/nmf.py``.

Each job starts from its own seed, so the reference is worked out again
for each sampled job.
"""

from __future__ import annotations

import torch

from repro_torch.analytics import nmf
from stepbench.reference import nmf as ref


def run_job(inputs: dict, cfg: dict, traffic: dict, session, job_seed: int):
    """One job through the port; returns its ``(P, Q)`` (numpy, as ``fit``
    does)."""
    p, q, _ = nmf.fit(inputs["r"], int(cfg["job"]["rank"]), iters=int(traffic["iters"]),
                      seed=job_seed, mode=traffic["mode"], session=session)
    return p, q


def control(inputs: dict, cfg: dict, traffic: dict, job_seed: int):
    """The reference in the program's place, in float32 with TF32 products
    (the configuration states float32 products with TF32 off)."""
    p, q = ref.factors(inputs["r"], int(cfg["job"]["rank"]), int(traffic["iters"]),
                       job_seed, torch.float32, tf32=True)
    return p.cpu().numpy(), q.cpu().numpy()


def readings(inputs: dict, cfg: dict, traffic: dict, samples) -> list:
    """``{name: reading}`` of each sampled job's output."""
    out = []
    for s in samples:
        p, q = ref.factors(inputs["r"], int(cfg["job"]["rank"]), int(traffic["iters"]),
                           s.job_seed)
        out.append({"p_gap": ref.gap(s.output[0], p), "q_gap": ref.gap(s.output[1], q)})
        del p, q
    return out
