"""PageRank cells: the port's ``pagerank.fit`` over a graph the benchmark
made on the device, judged by ``reference/pagerank.py``.

Every job of a cell runs the same graph from the same start, so one
reference serves every sampled job.
"""

from __future__ import annotations

import torch

from repro_torch.analytics import pagerank
from stepbench.reference import pagerank as ref


def run_job(inputs: dict, cfg: dict, traffic: dict, session, job_seed: int):
    """One job through the port; returns its ranks (numpy, as ``fit`` does)."""
    ranks, _ = pagerank.fit(inputs["edges"], inputs["n_vertices"],
                            iters=int(traffic["iters"]), mode=traffic["mode"],
                            session=session)
    return ranks


def control(inputs: dict, cfg: dict, traffic: dict, job_seed: int):
    """The reference in the program's place, its credit sums in float32
    (the configuration states float64 sums)."""
    return ref.ranks(inputs["edges"], inputs["n_vertices"], int(traffic["iters"]),
                     float(cfg["job"]["damping"]), torch.float32).cpu().numpy()


def readings(inputs: dict, cfg: dict, traffic: dict, samples) -> list:
    """``{name: reading}`` of each sampled job's output."""
    want = ref.ranks(inputs["edges"], inputs["n_vertices"], int(traffic["iters"]),
                     float(cfg["job"]["damping"]))
    return [{"rank_gap": ref.rank_gap(s.output, want)} for s in samples]
