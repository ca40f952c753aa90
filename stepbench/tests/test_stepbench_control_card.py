"""On the card, at each cell's own size: the control (the reference in the
program's place, at the precision below the one the configuration states)
reads above one of the cell's limits on three seeds, and the program reads
below every limit on the same seeds.  Card only:

    python -m pytest -q -m cuda stepbench/tests/test_stepbench_control_card.py
"""

import pytest

torch = pytest.importorskip("torch")

from stepbench import manifest  # noqa: E402
from stepbench.readings import readings  # noqa: E402

ROOT = manifest.HERE.parent
SEEDS = (2**31 + 101, 2**31 + 103, 2**31 + 107)


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cells run at their own size on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["pagerank-g500.auto", "nmf-netflix.auto"])
def test_control_fails_and_program_passes(cuda, workload):
    bench = manifest.benchmark(ROOT)
    limits = manifest.config(bench, ROOT, manifest.cell(bench, workload)["config"])["limits"]
    sides = []
    for r in readings(workload, SEEDS, SEEDS, root=ROOT):
        over = any(r[name] > limit for name, limit in limits.items())
        assert over == (r["side"] == "control"), r
        sides.append(r["side"])
    assert sides.count("control") == sides.count("program") == len(SEEDS)
