"""The port's kernel wrappers: plain versions against repro, the CPU route,
validation, and (on a card) each CUDA kernel against its plain version.

Tests marked ``cuda`` need an NVIDIA GPU with nvcc; they skip elsewhere.
The module imports JAX only inside the tests that compare with repro, so
``pytest -m cuda`` runs on a GPU machine without JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.sparse import block_layout  # noqa: E402
from repro_torch.data import kmeans_dataset  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.accumulate.fused_scatter import (  # noqa: E402
    fused_topk_scatter, fused_topk_scatter_plain)
from repro_torch.kernels.kmeans_assign.ops import (  # noqa: E402
    kmeans_assign, kmeans_assign_plain)
from repro_torch.kernels.topk_compress.ops import (  # noqa: E402
    topk_compress, topk_compress_plain)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would oversubscribe the CPU
    under the timing-sensitive tests of other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,k,seed", [(600, 8, 5, 1), (2000, 54, 7, 0), (300, 24, 11, 2)])
def test_kmeans_assign_plain_vs_repro_interpret(n, d, k, seed):
    """On kmeans_dataset's separated clusters the assignments are equal and
    dist² agrees to 1e-5 relative (the sums run in another order than
    XLA's).  The expanded formula rounds relative to ‖p‖² + ‖c‖², not to
    d², so near-zero distances (a center is itself a point) get an absolute
    margin of 1e-6·max‖p‖²."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.kmeans_assign.kernel import kmeans_assign_blocked

    x, _, _ = kmeans_dataset(n, d, k, seed=seed)
    ctr = x[np.random.default_rng(seed).choice(n, k, replace=False)]
    ja, jd = kmeans_assign_blocked(jnp.asarray(x), jnp.asarray(ctr), block_n=256,
                                   interpret=True)
    ta, td = kmeans_assign(torch.from_numpy(x), torch.from_numpy(ctr))
    assert ta.dtype == torch.int32 and td.dtype == torch.float32
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6 * float(np.max(np.sum(x * x, axis=1))))


def test_cpu_tensors_take_the_plain_route():
    """A CPU tensor runs the plain version and never touches a counter (no
    build, no launch)."""
    build.reset_launches()
    x = torch.randn(3, 700, generator=torch.Generator().manual_seed(0))
    _, be, pb = block_layout(700, 64)
    assert torch.equal(fused_topk_scatter(x, per_block=pb, block_eff=be),
                       fused_topk_scatter_plain(x, pb, be))
    for method in ("argmax", "bitonic"):
        i, v = topk_compress(x[0], k_per_block=5, block_v=256, method=method)
        pi, pv = topk_compress_plain(x[0], 5, 256)
        assert torch.equal(i, pi) and torch.equal(v, pv)
    pts, ctr = x[:, :30].reshape(10, 9), x[1, :18].reshape(2, 9)
    a, d = kmeans_assign(pts, ctr)
    pa, pd = kmeans_assign_plain(pts, ctr)
    assert torch.equal(a, pa) and torch.equal(d, pd)
    counts = build.launch_counts()
    assert set(counts) >= {"fused_topk_scatter", "topk_compress_argmax",
                           "topk_compress_bitonic", "kmeans_assign"}
    assert all(c == 0 for c in counts.values())


def test_fused_plain_keeps_input_dtype():
    x = torch.randn(2, 300, dtype=torch.bfloat16,
                    generator=torch.Generator().manual_seed(1))
    out = fused_topk_scatter(x, per_block=30, block_eff=300)
    assert out.dtype == torch.bfloat16 and out.shape == (300,)


def test_wrapper_validation():
    with pytest.raises(ValueError, match=r"\(N, V\)"):
        fused_topk_scatter(torch.zeros(8), per_block=2, block_eff=8)
    with pytest.raises(ValueError, match="per_block"):
        fused_topk_scatter(torch.zeros(2, 8), per_block=0, block_eff=8)
    with pytest.raises(ValueError, match="k_per_block"):
        topk_compress(torch.zeros(8), k_per_block=0)
    with pytest.raises(ValueError, match="centers"):
        kmeans_assign(torch.zeros(4, 3), torch.zeros(2, 5))
    with pytest.raises(ValueError, match="cpu or cuda"):
        topk_compress(torch.zeros(8, device="meta"), k_per_block=2)


def test_library_names_follow_their_sources():
    """Each source builds into its own library under build/, named by a
    digest of the source, the shared headers and the flags."""
    paths = {name: build.library_path(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(build.SOURCES)
    for name, p in paths.items():
        assert p.parent == build.BUILD_DIR and p.name.startswith(f"lib{name}_")
        assert (build.CSRC / f"{name}.cu").exists()
        assert build.library_path(name) == p


def test_chip_smoke_reads_the_ptxas_lines_of_the_named_kernels():
    """chip_smoke.py prints each flash body's registers and spills from
    build_all's -Xptxas -v output: the lines of each kernel whose mangled
    name holds the marker, under that name, and no other kernel's."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    tc, wg = ("_ZN2tc17flash_tf32_kernelILi128EEEvPKfS2_S2_Pfiiiiiiiif",
              "_ZN2wg18flash_wgmma_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_iiiiiiiif")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{wg}' for 'sm_90a'",
        f"ptxas info    : Function properties for {wg}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 239 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{tc}' for 'sm_90a'",
        f"ptxas info    : Function properties for {tc}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 228 registers, used 1 barriers"])
    assert chip_smoke.ptxas_lines(log, "flash_tf32_kernel") == [
        f"{tc}: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        f"{tc}: ptxas info    : Used 228 registers, used 1 barriers"]
    assert chip_smoke.ptxas_lines(log, "flash_wgmma_kernel") == [
        f"{wg}: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        f"{wg}: ptxas info    : Used 239 registers, used 1 barriers"]
    assert chip_smoke.ptxas_lines("", "flash_tf32_kernel") == []

# -- on the card: each CUDA kernel against its plain version -----------------


@pytest.mark.cuda
@pytest.mark.parametrize("n,v,k,block", [(4, 16384, 512, 1024), (8, 1000, 50, 256),
                                         (1, 100, 10, 1024), (3, 900, 900, 256),
                                         (2, 7, 3, 1024), (4, 512, 32, 1024)])
def test_fused_topk_scatter_kernel_bitexact(cuda, n, v, k, block):
    rng = np.random.default_rng(9)
    _, be, pb = block_layout(v, k, block)
    for density in (0.0, 0.01, 0.3, 1.0):
        m = rng.normal(size=(n, v)).astype(np.float32)
        m[rng.random((n, v)) >= density] = 0.0
        x = torch.from_numpy(m).to(cuda)
        before = build.launch_counts()["fused_topk_scatter"]
        got = fused_topk_scatter(x, per_block=pb, block_eff=be)
        torch.cuda.synchronize()
        assert build.launch_counts()["fused_topk_scatter"] == before + 1
        assert torch.equal(got, fused_topk_scatter_plain(x, pb, be))


@pytest.mark.cuda
@pytest.mark.parametrize("v,k,bv", [(900, 4, 256), (2048, 16, 512), (100, 2, 64),
                                    (1000, 200, 256), (4096, 256, 1024), (7, 3, 1024)])
def test_topk_compress_kernels_bitexact(cuda, v, k, bv):
    x = np.random.default_rng(7).normal(size=(v,)).astype(np.float32)
    x[np.random.default_rng(8).random(v) < 0.5] = 0.0
    xc = torch.from_numpy(x).to(cuda)
    pi, pv = topk_compress_plain(xc, k, min(bv, v))
    for method in ("argmax", "bitonic"):
        i, val = topk_compress(xc, k_per_block=k, block_v=bv, method=method)
        torch.cuda.synchronize()
        assert torch.equal(i, pi) and torch.equal(val, pv), method


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(600, 8, 5), (145_253, 54, 7)])
def test_kmeans_assign_kernel(cuda, n, d, k):
    x, _, _ = kmeans_dataset(n, d, k, seed=0)
    pts = torch.from_numpy(x).to(cuda)
    ctr = pts[:k].clone()
    a, dist = kmeans_assign(pts, ctr)
    pa, pd = kmeans_assign_plain(pts, ctr)
    torch.cuda.synchronize()
    assert torch.equal(a, pa)
    torch.testing.assert_close(dist, pd, rtol=1e-5,
                               atol=1e-6 * float((pts * pts).sum(1).max()))
