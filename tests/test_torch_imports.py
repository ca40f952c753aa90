"""The port stands alone: no module of src/repro_torch, and no line of
chip_smoke.py, imports jax or anything of the JAX package; entry points run
on the card unless the caller asks for the CPU."""

import ast
import pathlib

import numpy as np

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
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "examples").glob("torch_*.py"))
              + sorted((ROOT / "scripts").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])


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
    lm = ["configs/__init__.py", "configs/base.py", "configs/qwen3_1_7b.py",
          "configs/mamba2_2_7b.py", "configs/zamba2_2_7b.py", "models/common.py", "models/attention.py",
          "models/ffn.py", "models/mamba.py", "models/build.py", "models/convert.py",
          "kernels/flash_attention/ref.py", "kernels/flash_attention/ops.py",
          "kernels/flash_attention/kernel.py", "kernels/ssd_scan/ref.py",
          "kernels/ssd_scan/ops.py", "kernels/ssd_scan/kernel.py", "launch/steps.py",
          "launch/serve.py", "kernels/accumulate/ref.py", "kernels/accumulate/kernel.py",
          "kernels/accumulate/ops.py", "kernels/sparse_update/ref.py",
          "kernels/sparse_update/kernel.py", "kernels/sparse_update/ops.py",
          "analytics/nmf.py", "core/tiers.py", "utils/__init__.py", "utils/tree.py",
          "ft/__init__.py", "ft/checkpoint.py", "ft/heartbeat.py", "ft/elastic.py",
          "optim/__init__.py", "optim/optimizers.py", "optim/zero.py", "optim/compression.py",
          "data/pipeline.py", "data/synthetic.py", "launch/train.py", "launch/__init__.py",
          "launch/mesh.py", "launch/shardings.py", "launch/roofline.py", "launch/dryrun.py",
          "utils/hlo.py"]
    missing = [f for f in lm if f"src/repro_torch/{f}" not in names]
    assert not missing, missing
    for source in ("flash_attention.cu", "ssd_scan.cu", "accumulate.cu", "scatter_add.cu"):
        assert (ROOT / "src" / "repro_torch" / "csrc" / source).is_file(), source
    for example in ("torch_fault_tolerance_drill.py", "torch_train_lm.py",
                    "torch_quickstart.py", "torch_logistic_regression.py",
                    "torch_pagerank_graph.py", "torch_serve_lm.py"):
        assert f"examples/{example}" in names
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
    from repro_torch.analytics import kmeans, nmf
    from repro_torch.core import GlobalStore, Session
    from repro_torch.data import LMDataPipeline, shard_batch
    from repro_torch.device import resolve_device
    from repro_torch.launch import train
    from repro_torch.optim import ef_init

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (resolve_device, Session, GlobalStore,
                 lambda: Session(cold_tier="host", cold_budget=0),
                 lambda: kmeans.fit_reference([[0.0, 1.0], [1.0, 0.0]], 1, 1),
                 lambda: nmf.fit_reference(np.ones((2, 2), np.float32), 1, 1),
                 lambda: train("qwen3-1.7b", steps=1),
                 lambda: LMDataPipeline(2, 4, 10, prefetch=False),
                 lambda: shard_batch({"tokens": np.zeros((2, 4), np.int32)}),
                 lambda: ef_init(8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


class _OtherDevice(torch.Tensor):
    """A tensor that says it lives on a device neither CPU, CUDA nor meta
    (no storage; any op on it raises)."""

    @staticmethod
    def __new__(cls, *shape):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=torch.float32,
                                                   device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} ran on a tensor of another device")


def test_kernel_wrappers_raise_off_cpu_cuda_and_meta():
    """E's and F's wrappers take the plain version for a CPU tensor and, for
    shapes only, a meta one; any other device raises (a CUDA tensor always
    takes the kernel)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd, flash_attention_gqa
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan

    o = _OtherDevice
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention_gqa(o(1, 4, 1, 1, 8), o(1, 4, 1, 8), o(1, 4, 1, 8))
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention_bhsd(o(2, 4, 8), o(2, 4, 8), o(2, 4, 8))
    with pytest.raises(ValueError, match="cpu or cuda"):
        ssd_scan(o(1, 8, 2, 4), o(1, 8, 2), o(1, 8, 1, 4), o(1, 8, 1, 4), chunk=4)
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    assert flash_attention_gqa(meta(1, 4, 2, 2, 8), meta(1, 6, 2, 8), meta(1, 6, 2, 4)).shape \
        == (1, 4, 2, 2, 4)
    assert flash_attention_bhsd(meta(2, 4, 8), meta(2, 4, 8), meta(2, 4, 8)).is_meta
    assert ssd_scan(meta(1, 8, 2, 4), meta(1, 8, 2), meta(1, 8, 1, 4), meta(1, 8, 1, 4),
                    chunk=4).shape == (1, 8, 2, 4)
