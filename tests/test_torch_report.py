"""The port's report scripts against the JAX package's.

``scripts/torch_make_report.py`` and ``scripts/torch_compare_variants.py``
are loaded by path beside ``scripts/make_report.py`` and
``scripts/compare_variants.py``: the sample trace of a traced 2-thread
logreg fit has the same categories and span counts in both packages; the
findings report has no finding on any of the four apps and the same
findings' kinds on the seeded race (which thread reads first is
scheduling, so the tids are not compared); the dry-run matrix, the roofline
table and the variants' comparison printed from the port's records equal
what ``repro``'s scripts print from the same records (but the H100 note
column), with SKIP rows and "—" for a missing cell; neither port script
imports JAX or ``repro``."""

import collections
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.check import checker as stepcheck  # noqa: E402
from repro_torch.core import telemetry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
# small shapes for the dry run's smoke cells: blocked attention loops over
# key blocks, so a meta step's host work grows with the length (~6 s a
# smoke cell at train_4k's and prefill_32k's own)
SMALL = {"train_4k": (64, 8, "train"), "prefill_32k": (128, 4, "prefill"),
         "decode_32k": (256, 8, "decode")}
# (arch, shape, mesh, variant, overrides): a variant of a compare_variants
# cell, an encoder's decode cell (a skip file); every other cell is missing
CELLS = [("qwen3-1.7b", "train_4k", "single", "baseline", None),
         ("qwen3-1.7b", "train_4k", "single", "remat_none", {"remat": "none"}),
         ("qwen3-1.7b", "decode_32k", "single", "baseline", None),
         ("starcoder2-3b", "prefill_32k", "multi", "baseline", None),
         ("hubert-xlarge", "decode_32k", "single", "baseline", None)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _nothing_left_armed():
    """The port's checkers and tracers are process-wide: none stays armed."""
    yield
    leaked = (stepcheck.armed_count(), telemetry.armed_count())
    stepcheck.reset()
    telemetry.reset()
    assert leaked == (0, 0), f"test left (checkers, tracers) armed: {leaked}"


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                      f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {name: _script(name) for name in ("make_report", "torch_make_report",
                                             "compare_variants", "torch_compare_variants")}


@pytest.fixture(scope="module")
def small_cells():
    """Both packages' ARCHS at the cells' smoke configs and SHAPES at SMALL
    while the module runs, so that the records' MODEL_FLOPS are the same
    in both scripts."""
    with pytest.MonkeyPatch.context() as mp:
        for pkg in (configs, jconfigs):
            for arch in {c[0] for c in CELLS}:
                mp.setitem(pkg.ARCHS, arch, pkg.smoke_config(pkg.get_arch(arch)))
            for name, (t, b, kind) in SMALL.items():
                mp.setitem(pkg.SHAPES, name, type(pkg.SHAPES[name])(name, t, b, kind))
        yield


@pytest.fixture(scope="module")
def records(tmp_path_factory, small_cells):
    out = tmp_path_factory.mktemp("dryrun")
    for arch, shape, mesh, variant, overrides in CELLS:
        dryrun.run_cell(arch, shape, mesh, variant=variant, overrides=overrides,
                        out_dir=str(out), verbose=False)
    return str(out)


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def test_sample_trace_matches_repros(scripts, tmp_path):
    """The same categories and span counts per category (15 store-op, 15
    accumulate-round, 10 barrier-wait, 10 app-round)."""
    scripts["make_report"].export_sample_trace(str(tmp_path / "jax.json"))
    snap = scripts["torch_make_report"].export_sample_trace(str(tmp_path / "torch.json"),
                                                            device="cpu")
    spans = {}
    for name in ("jax", "torch"):
        with open(tmp_path / f"{name}.json") as f:
            events = json.load(f)["traceEvents"]
        spans[name] = collections.Counter(e["cat"] for e in events if e["ph"] == "X")
    assert spans["torch"] == spans["jax"]
    assert spans["torch"] == {"store-op": 15, "accumulate-round": 15, "barrier-wait": 10,
                              "app-round": 10}
    assert snap["spans_by_category"] == dict(spans["torch"]) and snap["events"] == 50


def test_check_report_matches_repros(scripts, tmp_path):
    """No finding on any app in either package; the seeded race found with
    the same kinds (one read-write, one write-write) in both."""
    scripts["make_report"].export_check_report(str(tmp_path / "jax.json"))
    port = scripts["torch_make_report"].export_check_report(str(tmp_path / "torch.json"),
                                                            device="cpu")
    with open(tmp_path / "jax.json") as f:
        ref = json.load(f)
    with open(tmp_path / "torch.json") as f:
        assert json.load(f) == port
    assert port["apps"].keys() == ref["apps"].keys() == {"logreg", "kmeans", "nmf",
                                                          "pagerank"}
    for name in ref["apps"]:
        assert port["apps"][name]["count"] == ref["apps"][name]["count"] == 0, name
    kinds = {name: sorted(f["kind"] for f in rep["seeded_race"]["findings"])
             for name, rep in (("jax", ref), ("torch", port))}
    assert port["seeded_race"]["count"] == ref["seeded_race"]["count"] == 2
    assert kinds["torch"] == kinds["jax"] == ["read-write", "write-write"]


def _rows(text, title):
    """The table rows under the heading that starts with ``title``."""
    lines = text.split("\n")
    start = next(i for i, line in enumerate(lines) if line.startswith(title))
    rows = []
    for line in lines[start + 1:]:
        if line.startswith("###"):
            break
        if line.startswith("| ") and not line.startswith("| arch"):
            rows.append(line)
    return rows


def test_tables_from_the_ports_records_are_repros(scripts, records, monkeypatch):
    port = scripts["torch_make_report"]
    recs, skips = port.load(records)
    assert len(recs) == 4 and len(skips) == 1
    matrix = port.matrix_lines(recs, skips)
    roof = port.roofline_lines(recs, skips)
    text = "\n".join(matrix + [""] + roof)
    assert len(_rows(text, "### Dry-run matrix")) == 40
    row = {line.split(" | ")[0][2:] + " " + line.split(" | ")[1]: line.split(" | ")[2:]
           for line in _rows(text, "### Dry-run matrix")}
    assert row["qwen3-1.7b train_4k"][0].startswith("OK — peak ")
    assert row["qwen3-1.7b train_4k"][1] == "— |"
    assert row["starcoder2-3b prefill_32k"][0] == "—"
    assert row["starcoder2-3b prefill_32k"][1].startswith("OK — peak ")
    assert row["hubert-xlarge decode_32k"][0] == "SKIP (encoder-only)"
    assert row["qwen2-72b train_4k"] == ["—", "— |"]
    roof_rows = _rows(text, "### Roofline")
    assert len(roof_rows) == 3                        # two records and the skip, single-pod
    assert any("| skipped |" in line for line in roof_rows)
    assert all("MXU" not in line and "VMEM" not in line and "Pallas" not in line
               for line in roof_rows)

    # repro's script over the same records prints the same tables, but the
    # note, which speaks of the TPU there and of the H100 here
    monkeypatch.setattr(sys, "argv", ["make_report.py", "--out", records,
                                      "--trace-bench", "none", "--check-bench", "none"])
    ref = _printed(scripts["make_report"].main)
    assert _rows(ref, "### Dry-run matrix") == _rows(text, "### Dry-run matrix")

    def but_note(rows):
        return [line.split(" | ")[:-1] for line in rows]

    assert but_note(_rows(ref, "### Roofline")) == but_note(roof_rows)
    assert _printed(port.main, ["--out", records]).strip() == text.strip()


def test_compare_variants_from_the_ports_records_is_repros(scripts, records):
    """The baseline and its variant for qwen3-1.7b train_4k, the other two
    cells empty; the same text as repro's script over the same records."""
    text = _printed(scripts["torch_compare_variants"].main, records)
    assert text == _printed(scripts["compare_variants"].main, records)
    block = text.split("=== ")[1].split("\n")
    assert block[0] == "qwen3-1.7b × train_4k (single-pod, per device) ==="
    assert [line.split()[0] for line in block[2:] if line] == ["baseline", "remat_none"]
    assert block[3].split()[5].startswith(("+", "-"))
    assert text.count("=== ") == 3


def test_scripts_import_no_jax_or_repro(records, tmp_path):
    """Both scripts' tables and the trace export, in a fresh process: no
    ``jax`` and no ``repro`` module is loaded."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    code = (
        "import importlib.util, os, sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "def load(name):\n"
        f"    path = os.path.join({ROOT!r}, 'scripts', name + '.py')\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    return mod\n"
        "report, variants = load('torch_make_report'), load('torch_compare_variants')\n"
        f"report.main(['--out', {records!r}])\n"
        f"report.main(['--export-trace', {str(tmp_path / 't.json')!r}, '--device', 'cpu'])\n"
        f"variants.main({records!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean") and "50 events" in out.stdout
