"""Logistic-regression cells: the port's ``logreg.fit`` over a sparse
design matrix the benchmark made on the device, judged by
``reference/logreg.py``.

Every job of a cell runs the same data from theta = 0, so one reference
serves every sampled job.
"""

from __future__ import annotations

import torch

from repro_torch.analytics import logreg
from repro_torch.data.csr import CSRMatrix
from stepbench.reference import logreg as ref


def _lr(inputs: dict, cfg: dict) -> float:
    """The step on the summed gradient: the configuration's step on the
    mean log-loss over the rows."""
    return float(cfg["job"]["step_on_mean_loss"]) / inputs["y"].shape[0]


def _reference(inputs: dict, cfg: dict, traffic: dict, dtype=torch.float64):
    return ref.theta(inputs["indptr"], inputs["indices"], inputs["values"],
                     inputs["n_features"], inputs["y"], int(traffic["iters"]),
                     _lr(inputs, cfg), dtype)


def run_job(inputs: dict, cfg: dict, traffic: dict, session, job_seed: int):
    """One job through the port; returns its theta (numpy, as ``fit`` does)."""
    x = CSRMatrix(inputs["indptr"], inputs["indices"], inputs["values"], inputs["n_features"])
    theta, _ = logreg.fit(x, inputs["y"], iters=int(traffic["iters"]), lr=_lr(inputs, cfg),
                          mode=traffic["mode"], session=session)
    return theta


def control(inputs: dict, cfg: dict, traffic: dict, job_seed: int):
    """The reference in the program's place, its gradient sums in float32
    (the configuration states float64 sums)."""
    return _reference(inputs, cfg, traffic, torch.float32).cpu().numpy()


def readings(inputs: dict, cfg: dict, traffic: dict, samples) -> list:
    """``{name: reading}`` of each sampled job's output."""
    want = _reference(inputs, cfg, traffic)
    return [{"theta_gap": ref.theta_gap(s.output, want)} for s in samples]
