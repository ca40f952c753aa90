"""A run with the timed path broken underneath it reads ``correct`` false:
the harness's whole run on the CPU (the look for a card left out), once
for each fault these cells can have, and once unbroken."""

import pytest
import torch

from repro_torch.analytics import nmf, pagerank
from repro_torch.core import session as session_mod
from stepbench import manifest
from stepbench.runner import run_cell
from stepbench.tests.small import SEED, SMALL

ROOT = manifest.HERE.parent


def _state_unchanged(monkeypatch, workload):
    """A round that leaves the shared state (ranks, Q) as it was."""
    monkeypatch.setattr(session_mod.SharedRef, "set", lambda self, value: None)


def _half_the_work(monkeypatch, workload):
    """Half of each thread's edges or rows left out, the rest counted twice."""
    if workload.startswith("pagerank"):
        credits = pagerank._credits

        def half(src, dst, ranks, out_deg, n):
            h = src.shape[0] // 2
            return 2 * credits(src[:h], dst[:h], ranks, out_deg, n)
        monkeypatch.setattr(pagerank, "_credits", half)
    else:
        def half(p, r):
            h = p.shape[0] // 2
            return 2 * (p[:h].T @ r[:h]), 2 * (p[:h].T @ p[:h])
        monkeypatch.setattr(nmf, "_q_partials", half)


def _no_exchange(monkeypatch, workload):
    """The accumulator's exchange left out: each thread keeps its own part."""
    monkeypatch.setattr(session_mod.SharedRef, "accumulate",
                        lambda self, local, mode=None, k=None: torch.as_tensor(local))


def _answer_altered(monkeypatch, workload):
    """One entry of the job's answer altered where the job returns it."""
    if workload.startswith("pagerank"):
        fit = pagerank.fit

        def altered(*a, **kw):
            ranks, sess = fit(*a, **kw)
            ranks[7] *= 1.001
            return ranks, sess
        monkeypatch.setattr(pagerank, "fit", altered)
    else:
        fit = nmf.fit

        def altered(*a, **kw):
            p, q, sess = fit(*a, **kw)
            q[0, int(q[0].argmax())] *= 1.01
            return p, q, sess
        monkeypatch.setattr(nmf, "fit", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_the_work": _half_the_work,
          "no_exchange": _no_exchange, "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", [None, *FAULTS])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_broken_path_reads_not_correct(monkeypatch, workload, fault):
    if fault is not None:
        FAULTS[fault](monkeypatch, workload)
    result = run_cell(workload, SEED, 0.1, False, root=ROOT, device="cpu",
                      overrides=SMALL[workload])
    assert result.attempted >= 1
    assert result.correct is (fault is None), result.checks
