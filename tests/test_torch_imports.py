"""The port stands alone: no module of src/repro_torch, and no line of
chip_smoke.py, imports jax or anything of the JAX package; entry points run
on the card unless the caller asks for the CPU."""

import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would oversubscribe the CPU
    under the timing-sensitive tests of other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/core/session.py" in names
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported_modules(path)
           if m == "jax" or m.startswith("jax.") or m == "jaxlib"
           or m == "repro" or m.startswith("repro.")]
    assert not bad, f"{path.name} imports {bad}"


def test_default_device_raises_without_a_gpu(monkeypatch):
    """device=None means the card: on a host with no visible GPU the entry
    points raise instead of falling back to the CPU."""
    from repro_torch.analytics import kmeans
    from repro_torch.core import GlobalStore, Session
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (resolve_device, Session, GlobalStore,
                 lambda: kmeans.fit_reference([[0.0, 1.0], [1.0, 0.0]], 1, 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
