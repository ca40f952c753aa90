"""The logistic-regression cell (``logreg-kdd2010b.auto``) on the CPU at a
small size: its result line, faults under the timed path that read
``correct`` false, its reference on a case worked by hand, and its frozen
roofline counts."""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.analytics import logreg
from repro_torch.core import session as session_mod
from stepbench import manifest
from stepbench.reference import logreg as ref
from stepbench.runner import run_cell
from stepbench.tests.small import SEED

ROOT = manifest.HERE.parent
BENCH = manifest.benchmark(ROOT)
CELL = "logreg-kdd2010b.auto"
# the configuration's shape at a small scale: 29.40 nonzeros a row, as the set
SMALL = {"matrix": {"rows": 3001, "features": 5003, "nnz": 88_235, "zipf_exponent": 1.0}}


def _run(trace=False, seconds=0.1):
    return run_cell(CELL, SEED, seconds, trace, root=ROOT, device="cpu", overrides=SMALL)


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace):
    line = json.loads(json.dumps(_run(bool(trace), 0.2).line()))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    section = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in manifest.metrics_of(BENCH, section, CELL)}
    assert line["metrics"] and set(line["metrics"]) <= set(allowed)
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == allowed[name]
    if trace:
        # the program's spans and counts: every per-layer metric but the
        # device's (no card here) reads something
        assert set(line["metrics"]) == set(allowed) - {
            "device_idle_pct", "margin_roofline_pct", "grad_roofline_pct"}
        assert line["metrics"]["wire_melem_per_iter"]["value"] == pytest.approx(
            5 * 5003 / 1e6)                 # every round dense: (threads + 1) x features
    else:
        assert {"iter_ms", "setup_s"} <= set(line["metrics"])
    assert set(line["checks"]) == {"theta_gap"}
    assert line["checks"]["theta_gap"]["value"] <= line["checks"]["theta_gap"]["limit"]


def _theta_unchanged(monkeypatch):
    """A round whose accumulated gradient is zero: theta stays at 0."""
    monkeypatch.setattr(session_mod.SharedRef, "accumulate",
                        lambda self, local, mode=None, k=None: torch.zeros_like(local))


def _half_the_rows(monkeypatch):
    """Half of each thread's rows left out, the rest counted twice."""
    grad = logreg._csr_grad

    def half(theta, xs, ys, rows):
        h = xs.shape[0] // 2
        part = xs[:h]
        return 2 * grad(theta, part, ys[:h], part.row_ids())
    monkeypatch.setattr(logreg, "_csr_grad", half)


def _no_exchange(monkeypatch):
    """The accumulator's exchange left out: each thread keeps its own part."""
    monkeypatch.setattr(session_mod.SharedRef, "accumulate",
                        lambda self, local, mode=None, k=None: torch.as_tensor(local))


FAULTS = {"theta_unchanged": _theta_unchanged, "half_the_rows": _half_the_rows,
          "no_exchange": _no_exchange}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_a_broken_path_reads_not_correct(monkeypatch, fault):
    if fault is not None:
        FAULTS[fault](monkeypatch)
    result = _run()
    assert result.attempted >= 1
    assert result.correct is (fault is None), result.checks


def test_reference_one_round_by_hand():
    # rows: x0 = (0.6 at 0, 0.8 at 2), x1 = (1.0 at 1); labels 1, 0; theta 0
    indptr = torch.tensor([0, 2, 3])
    indices = torch.tensor([0, 2, 1], dtype=torch.int32)
    values = torch.tensor([0.6, 0.8, 1.0])
    y = torch.tensor([1.0, 0.0])
    th = ref.theta(indptr, indices, values, 3, y, iters=1, lr=0.5)
    # r = y - 1/2 = (0.5, -0.5); g = X^T r = (0.3, -0.5, 0.4)
    v = values.double()
    want = 0.5 * torch.tensor([0.5 * v[0], -0.5 * v[2], 0.5 * v[1]], dtype=torch.float64)
    torch.testing.assert_close(th, want, rtol=1e-15, atol=0)
    got = (want * (1 + 1e-4)).float().numpy()
    assert ref.theta_gap(got, th) == pytest.approx(1e-4, rel=1e-3)


def test_reference_blocks_cover_every_row_once():
    indptr = torch.tensor([0, 3, 3, 10, 11, 30, 31])
    blocks = list(ref.row_blocks(indptr, block=4))
    assert [b[:2] for b in blocks] == [(0, 2), (2, 3), (3, 4), (4, 5), (5, 6)]
    assert all(int(indptr[lo]) == a and int(indptr[hi]) == b for lo, hi, a, b in blocks)


def test_control_reads_the_lower_precision():
    from stepbench.generators import sparse_rows
    d = sparse_rows.make(SMALL, torch.Generator().manual_seed(2), torch.device("cpu"))
    args = (d["indptr"], d["indices"], d["values"], d["n_features"], d["y"], 10, 1 / 3001)
    th32 = ref.theta(*args, torch.float32)
    assert th32.dtype == torch.float32
    assert 0 < ref.theta_gap(th32.numpy(), ref.theta(*args)) < 1e-3


def test_logreg_kdd2010b_counts():
    cfg = manifest.load_json(ROOT / "stepbench" / "configs" / "logreg-kdd2010b.json")
    roof = manifest.module("roofline", "logreg-kdd2010b")
    rows, features, nnz = 19_264_097, 29_890_095, 566_345_888
    # 16 B a nonzero (9.0615 GB), 12 B a row (0.2312 GB), 20 B a feature
    # (0.5978 GB): 9.8905 GB, 2.952 ms at 3.35 TB/s
    assert roof.iteration_bytes(cfg) == 16 * nnz + 12 * rows + 20 * features
    assert roof.iteration_bytes(cfg) == pytest.approx(9.8905e9, rel=1e-4)
    assert roof.iteration_least_s(cfg) * 1e3 == pytest.approx(2.952, abs=1e-3)
    k = roof.kernel_least_s(cfg)
    # a quarter of the nonzeros at 8 B (1.1327 GB) and of the rows at 8 B
    # (38.5 MB): 0.3496 ms; the gradient's: the nonzeros at 8 B, the rows
    # at 4 B (19.3 MB), the whole gradient written (119.6 MB): 0.3796 ms
    assert k["margin_kernel"] * 1e3 == pytest.approx(0.3496, abs=1e-4)
    assert k["credits_kernel"] * 1e3 == pytest.approx(0.3796, abs=1e-4)
    # G: four gradients read and one written, 5 x 4 B a feature (597.8 MB): 0.1784 ms
    assert k["accumulate_kernel"] * 1e3 == pytest.approx(0.1784, abs=1e-4)
    assert set(k) == {"margin_kernel", "credits_kernel", "accumulate_kernel"}


def test_configuration_states_the_published_set():
    cfg = manifest.load_json(ROOT / "stepbench" / "configs" / "logreg-kdd2010b.json")
    entry = next(c for c in BENCH["configs"] if c["name"] == "logreg-kdd2010b")
    assert entry["reduced"] == []
    assert (cfg["matrix"]["rows"], cfg["matrix"]["features"], cfg["matrix"]["nnz"]) == (
        19_264_097, 29_890_095, 566_345_888)
    assert {"popularity", "values", "labels", "session", "row_lengths"} <= set(cfg["assumed"])


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys; from pathlib import Path\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from stepbench.run import forbidden_modules\n"
        "from stepbench.runner import run_cell\n"
        "from stepbench.tests.small import SEED\n"
        "from stepbench.tests.test_stepbench_logreg import CELL, SMALL\n"
        f"r = run_cell(CELL, SEED, 0.1, True, root=Path({str(ROOT)!r}), device='cpu',"
        " overrides=SMALL)\n"
        "assert r.correct, r.checks\n"
        "print('FORBIDDEN', forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "OMP_NUM_THREADS": "1"}, timeout=240,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
