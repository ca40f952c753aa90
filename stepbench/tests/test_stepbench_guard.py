"""The import guard: no module of JAX or of the JAX package (``repro``) in
a run, compared by whole top-level names, and a reference that imports
nothing of the port."""

import ast
import os
import subprocess
import sys

from stepbench import manifest
from stepbench.run import FORBIDDEN, forbidden_modules

ROOT = manifest.HERE.parent
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_top_level_names_compared_whole():
    assert forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping",
                              "reprolib", "torch"]) == []
    assert forbidden_modules(["repro.core.session", "torch"]) == ["repro"]
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}


def test_no_source_under_the_benchmark_imports_jax_or_repro():
    for path in manifest.HERE.rglob("*.py"):
        if "tests" in path.relative_to(manifest.HERE).parts:
            continue
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(FORBIDDEN), path


def test_references_import_nothing_of_the_port():
    for path in (manifest.HERE / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert tops <= {"__future__", "numpy", "torch"}, (path, tops)


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys; from pathlib import Path\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from stepbench.run import forbidden_modules\n"
        "from stepbench.runner import run_cell\n"
        "from stepbench.tests.small import SEED, SMALL\n"
        "for w, o in SMALL.items():\n"
        f"    r = run_cell(w, SEED, 0.1, True, root=Path({str(ROOT)!r}), device='cpu',"
        " overrides=o)\n"
        "    assert r.correct, r.checks\n"
        "print('FORBIDDEN', forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=ONE_THREAD,
                         timeout=240, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout
