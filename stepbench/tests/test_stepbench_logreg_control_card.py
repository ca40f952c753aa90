"""On the card, at the logistic-regression cell's own size: the control
(the reference in the program's place, its gradient sums in float32, one
precision below the configuration's float64) reads above the cell's
``theta_gap`` limit on three seeds, and the program reads below it on the
same seeds.  Card only:

    python -m pytest -q -m cuda stepbench/tests/test_stepbench_logreg_control_card.py
"""

import pytest

torch = pytest.importorskip("torch")

from stepbench import manifest  # noqa: E402
from stepbench.readings import readings  # noqa: E402

ROOT = manifest.HERE.parent
SEEDS = (2**31 + 101, 2**31 + 103, 2**31 + 107)
CELL = "logreg-kdd2010b.auto"


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cell runs at its own size on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_control_fails_and_program_passes(cuda):
    bench = manifest.benchmark(ROOT)
    limits = manifest.config(bench, ROOT, manifest.cell(bench, CELL)["config"])["limits"]
    sides = []
    for r in readings(CELL, SEEDS, SEEDS, root=ROOT):
        over = any(r[name] > limit for name, limit in limits.items())
        assert over == (r["side"] == "control"), r
        sides.append(r["side"])
    assert sides.count("control") == sides.count("program") == len(SEEDS)
