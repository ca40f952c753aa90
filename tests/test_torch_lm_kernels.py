"""The LM kernels of the port: flash attention and the SSD scan.

On the CPU each wrapper runs its plain version, held here against repro's
Pallas kernels in interpret mode on the same numpy inputs, with
tests/test_kernels.py's tolerances.  Tests marked ``cuda`` hold each CUDA
kernel against its plain version on a card; they skip elsewhere.  JAX is
imported only inside the tests that compare with repro, so ``pytest -m
cuda`` runs on a GPU machine without JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    MAX_HEAD_DIM, flash_attention_bhsd, gqa_plain, smem_bytes)
from repro_torch.kernels.flash_attention.ref import attention_bhsd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan, ssd_scan_bh  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_chunked, ssd_scan_plain, ssd_sequential_ref)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import or collection)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions in full fp32
    return torch.device("cuda")


DTYPES = ["float32", "bfloat16"]
# tests/test_kernels.py's flash sweep: (BH, T, S, d, dv, causal, block_q, block_k)
FLASH_SHAPES = [
    (2, 128, 128, 64, 64, True, 64, 64),
    (1, 96, 160, 32, 16, False, 64, 64),
    (3, 64, 64, 128, 128, True, 32, 32),
    (1, 17, 33, 16, 16, True, 8, 16),
]


def _tol(dtype: str) -> dict:
    return dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else dict(rtol=3e-5, atol=3e-5)


def _flash_inputs(BH, T, S, d, dv, dtype, seed=0):
    """q, k, v as numpy float32 (already rounded to ``dtype``) and as torch."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=shape).astype(np.float32)
              for shape in ((BH, T, d), (BH, S, d), (BH, S, dv))]
    tensors = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return [t.float().numpy() for t in tensors], tensors


def _ssd_inputs(b=2, T=64, H=4, P=8, G=2, N=16, seed=6):
    """tests/test_kernels.py's SSD inputs (numpy float32)."""
    rng = np.random.default_rng(seed)
    xs = (rng.normal(size=(b, T, H, P)) * 0.5).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, T, H))) * 0.5 + 0.1).astype(np.float32)
    A_log = np.log(np.linspace(1.0, 4.0, H)).astype(np.float32)
    B = (rng.normal(size=(b, T, G, N)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(b, T, G, N)) * 0.3).astype(np.float32)
    return xs, dt, A_log, B, C


# -- flash attention: the plain version against repro ----------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("BH,T,S,d,dv,causal,bq,bk", FLASH_SHAPES)
def test_flash_plain_vs_repro_interpret(dtype, BH, T, S, d, dv, causal, bq, bk):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.kernel import flash_attention_bhsd as jax_flash

    arrays, (q, k, v) = _flash_inputs(BH, T, S, d, dv, dtype)
    ja = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    ref = jax_flash(*ja, causal=causal, block_q=bq, block_k=bk, interpret=True)
    out = flash_attention_bhsd(q, k, v, causal=causal)
    assert out.dtype == q.dtype and out.shape == (BH, T, dv)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), **_tol(dtype))


@pytest.mark.parametrize("q_offset", [0, 5, 32])
def test_flash_plain_q_offset_vs_repro_interpret(q_offset):
    """Queries at positions q_offset + t against a longer key sequence."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.kernel import flash_attention_bhsd as jax_flash

    arrays, (q, k, v) = _flash_inputs(2, 16, 48, 32, 32, "float32", seed=3)
    ref = jax_flash(*map(jnp.asarray, arrays), causal=True, q_offset=q_offset,
                    block_q=8, block_k=16, interpret=True)
    out = flash_attention_bhsd(q, k, v, causal=True, q_offset=q_offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_tol("float32"))


@pytest.mark.parametrize("B,T,S,KH,G,dh,q_offset", [(2, 64, 64, 2, 3, 32, 0),
                                                    (1, 8, 40, 2, 2, 16, 32)])
def test_flash_gqa_ops_vs_repro(B, T, S, KH, G, dh, q_offset):
    """ops.flash_attention on the GQA layout (B, T, KH, G, d) against repro's
    wrapper, which folds (KH, G) and broadcasts K/V over G."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.ops import flash_attention as jax_ops_flash

    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, T, KH, G, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, KH, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, KH, dh)).astype(np.float32)
    ref = jax_ops_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                        q_offset=q_offset, block_q=32, block_k=32, interpret=True)
    out = fa_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True, q_offset=q_offset)
    assert out.shape == (B, T, KH, G, dh)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


# -- SSD scan: the plain version against repro ---------------------------------------


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_plain_vs_repro_interpret(chunk):
    """ops.ssd on CPU tensors (the chunked plain version) against repro's
    kernel in interpret mode, and both against the sequential recurrence."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssd_scan.ops import ssd as jax_ssd
    from repro.kernels.ssd_scan.ref import ssd_sequential_ref as jax_sequential

    inputs = _ssd_inputs()
    ref, _ = jax_ssd(*map(jnp.asarray, inputs), chunk=chunk, interpret=True)
    y, state = ssd_ops.ssd(*map(torch.from_numpy, inputs), chunk=chunk)
    assert state is None and y.shape == inputs[0].shape
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=3e-4, atol=3e-4)
    seq = ssd_sequential_ref(*map(torch.from_numpy, inputs))
    np.testing.assert_allclose(seq.numpy(), np.asarray(jax_sequential(*map(jnp.asarray, inputs))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.numpy(), seq.numpy(), rtol=3e-4, atol=3e-4)


def test_ssd_chunked_final_state_vs_repro():
    """The chunked reference's final state, which decode continues from."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models.mamba import ssd_chunked as jax_chunked

    inputs = _ssd_inputs(T=32)
    jy, jh = jax_chunked(*map(jnp.asarray, inputs), chunk=8)
    y, h = ssd_chunked(*map(torch.from_numpy, inputs), chunk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)


def test_ssd_scan_bh_vs_repro_interpret():
    """The TPU kernel's (BH, T, ·) form on already-transformed inputs."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssd_scan.kernel import ssd_scan_bh as jax_scan_bh

    rng = np.random.default_rng(4)
    x = (rng.normal(size=(3, 32, 8)) * 0.5).astype(np.float32)
    a = -(np.abs(rng.normal(size=(3, 32))) * 0.3).astype(np.float32)
    bm = (rng.normal(size=(3, 32, 16)) * 0.3).astype(np.float32)
    cm = (rng.normal(size=(3, 32, 16)) * 0.3).astype(np.float32)
    ref = jax_scan_bh(*map(jnp.asarray, (x, a, bm, cm)), chunk=16, interpret=True)
    out = ssd_scan_bh(*map(torch.from_numpy, (x, a, bm, cm)), chunk=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-4, atol=3e-4)


# -- routing and validation ---------------------------------------------------------


def test_cpu_tensors_take_the_plain_route():
    """A CPU tensor runs the plain version and never touches a counter."""
    build.reset_launches()
    _, (q, k, v) = _flash_inputs(2, 16, 16, 8, 8, "float32")
    assert torch.equal(flash_attention_bhsd(q, k, v), attention_bhsd_ref(q, k, v))
    q5, k4, v4 = q.reshape(1, 16, 1, 2, 8), k.reshape(1, 16, 2, 8)[:, :, :1], v[:1, :, None]
    assert torch.equal(fa_ops.flash_attention(q5, k4, v4),
                       gqa_plain(q5, k4, v4, causal=True, q_offset=0))
    xs, dt, A_log, B, C = map(torch.from_numpy, _ssd_inputs(T=16))
    a = (dt * -torch.exp(A_log)).float()
    xbar = xs * dt[..., None]
    assert torch.equal(ssd_scan(xbar, a, B, C, chunk=8), ssd_scan_plain(xbar, a, B, C, 8)[0])
    counts = build.launch_counts()
    assert counts["flash_attention"] == 0 and counts["ssd_scan"] == 0


def test_wrapper_validation():
    with pytest.raises(ValueError, match=r"\(B, T, KH, G, dk\)"):
        fa_ops.flash_attention(torch.zeros(1, 4, 8), torch.zeros(1, 4, 8), torch.zeros(1, 4, 8))
    with pytest.raises(ValueError, match="do not match"):
        fa_ops.flash_attention(torch.zeros(1, 4, 2, 1, 8), torch.zeros(1, 4, 1, 8),
                               torch.zeros(1, 4, 1, 8))
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa_ops.flash_attention(torch.zeros(1, 4, 1, 1, 8, device="meta"),
                               torch.zeros(1, 4, 1, 8), torch.zeros(1, 4, 1, 8))
    xs, dt, A_log, B, C = map(torch.from_numpy, _ssd_inputs(T=24))
    with pytest.raises(ValueError, match="T % chunk"):
        ssd_ops.ssd(xs, dt, A_log, B, C, chunk=16)
    with pytest.raises(ValueError, match=r"xbar \(b,T,H,P\)"):
        ssd_scan(xs[0], dt, B, C, chunk=8)
    with pytest.raises(ValueError, match="multiple of G"):
        ssd_scan(xs, dt, torch.zeros(2, 24, 3, 16), torch.zeros(2, 24, 3, 16), chunk=8)


def test_library_names_cover_the_lm_kernels():
    for name in ("flash_attention", "ssd_scan"):
        assert name in build.SOURCES and (build.CSRC / f"{name}.cu").exists()
        assert build.library_path(name).name.startswith(f"lib{name}_")


# -- on the card: each CUDA kernel against its plain version -----------------------


# the edges of the kernels' tiling: d a multiple of 4 but not of 8 (20 and
# 12: the bf16 body's 8-byte copies), the hubert / zamba2 head dim (80),
# MLA's dk != dv (192 / 128), T > S with S not a multiple of the KV tile
# (causal and not)
FLASH_EDGE_SHAPES = [(2, 50, 70, 20, 20, True, 0, 0), (2, 130, 130, 80, 80, True, 0, 0),
                     (2, 100, 150, 192, 128, False, 0, 0), (1, 200, 77, 64, 64, True, 0, 0),
                     (1, 200, 77, 128, 128, False, 0, 0), (2, 90, 140, 12, 12, True, 0, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("BH,T,S,d,dv,causal,bq,bk",
                         FLASH_SHAPES + [(2, 100, 300, 256, 200, False, 0, 0),
                                         (1, 70, 70, 96, 96, True, 0, 0)] + FLASH_EDGE_SHAPES)
def test_flash_kernel_vs_plain(cuda, dtype, BH, T, S, d, dv, causal, bq, bk):
    _, tensors = _flash_inputs(BH, T, S, d, dv, dtype)
    q, k, v = (t.to(cuda) for t in tensors)
    before = build.launch_counts()["flash_attention"]
    out = flash_attention_bhsd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert build.launch_counts()["flash_attention"] == before + 1
    assert out.dtype == q.dtype
    ref = attention_bhsd_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,S,KH,G,dh,q_offset", [(2, 64, 64, 2, 3, 32, 0),
                                                    (1, 8, 40, 2, 2, 16, 32),
                                                    (2, 130, 200, 4, 2, 128, 70),
                                                    (2, 1, 300, 8, 2, 128, 299),
                                                    (1, 2048, 2048, 8, 2, 128, 0)])
def test_flash_kernel_gqa_vs_plain(cuda, dtype, B, T, S, KH, G, dh, q_offset):
    """The GQA layout, with a decode-shaped call (T = 1, q_offset = S - 1)
    and the qwen3-1.7b prefill shape at B = 1."""
    rng = np.random.default_rng(2)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda, dt)
               for s in ((B, T, KH, G, dh), (B, S, KH, dh), (B, S, KH, dh)))
    before = build.launch_counts()["flash_attention"]
    out = fa_ops.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    assert build.launch_counts()["flash_attention"] == before + 1
    ref = gqa_plain(q, k, v, causal=True, q_offset=q_offset)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_takes_views_off_16_bytes(cuda, dtype):
    """Both bodies stage rows with 16-byte cp.async: q, k, v that start one
    element (4 bytes in fp32, 2 in bf16) past an aligned address are copied
    first, not misread."""
    rng = np.random.default_rng(3)
    dt = getattr(torch, dtype)

    def off(shape):
        flat = rng.normal(size=int(np.prod(shape)) + 1).astype(np.float32)
        return torch.from_numpy(flat).to(cuda, dt)[1:].view(shape)

    q, k, v = off((1, 40, 2, 2, 32)), off((1, 50, 2, 32)), off((1, 50, 2, 32))
    assert q.data_ptr() % 16 and k.data_ptr() % 16 and v.data_ptr() % 16
    out = fa_ops.flash_attention(q, k, v, causal=True, q_offset=10)
    ref = gqa_plain(q, k, v, causal=True, q_offset=10)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,at_128", [("float32", 215_040), ("bfloat16", 164_864)])
def test_flash_smem_fits_every_head_dim_the_kernel_takes(cuda, dtype, at_128):
    """Each body's shared memory per CTA, as csrc/flash_attention.cu computes
    it (float32: the 3xTF32 body's Q tile and two K/V stages; bfloat16: the
    wgmma body's swizzled Q tile and two K/V stages, 160 KB, plus 1 KB that
    aligns them), fits Hopper's 227 KB for every dk, dv the wrapper accepts,
    multiples of 4 up to 256; at qwen3's head dim 128 it is as the kernel's
    note states."""
    dt = getattr(torch, dtype)
    dims = range(4, MAX_HEAD_DIM + 1, 4)
    assert max(smem_bytes(dk, dv, dt) for dk in dims for dv in dims) <= 227 * 1024
    assert smem_bytes(128, 128, dt) == at_128


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,H,G,P,N", [(8, 4, 2, 8, 16), (16, 4, 2, 8, 16),
                                           (32, 4, 2, 8, 16), (128, 3, 1, 64, 128),
                                           (16, 4, 2, 20, 12), (32, 4, 2, 7, 13),
                                           (64, 2, 1, 96, 40)])
def test_ssd_kernel_vs_plain(cuda, chunk, H, G, P, N):
    xs, dt, A_log, B, C = (torch.from_numpy(t).to(cuda)
                           for t in _ssd_inputs(T=256, H=H, P=P, G=G, N=N))
    a = (dt * -torch.exp(A_log)).float()
    xbar = xs * dt[..., None]
    before = build.launch_counts()["ssd_scan"]
    y = ssd_scan(xbar, a, B, C, chunk=chunk)
    torch.cuda.synchronize()
    assert build.launch_counts()["ssd_scan"] == before + 1
    ref, _ = ssd_scan_plain(xbar, a, B, C, chunk)
    np.testing.assert_allclose(y.cpu().numpy(), ref.cpu().numpy(), rtol=3e-4, atol=3e-4)


def _ssd_cuda(cuda, T, H, P, G, N, seed=6):
    xs, dt, A_log, B, C = (torch.from_numpy(t).to(cuda)
                           for t in _ssd_inputs(T=T, H=H, P=P, G=G, N=N, seed=seed))
    return xs * dt[..., None], (dt * -torch.exp(A_log)).float(), B, C


@pytest.mark.cuda
def test_ssd_kernel_long_chain(cuda):
    """Chunk 8 over T 512: 64 chunks a head, each an item that waits for its
    predecessor's state, on 8 (batch, head) chains."""
    xbar, a, B, C = _ssd_cuda(cuda, 512, 4, 8, 2, 16)
    before = build.launch_counts()["ssd_scan"]
    y = ssd_scan(xbar, a, B, C, chunk=8)
    torch.cuda.synchronize()
    assert build.launch_counts()["ssd_scan"] == before + 1
    np.testing.assert_allclose(y.cpu().numpy(), ssd_scan_plain(xbar, a, B, C, 8)[0].cpu().numpy(),
                               rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
def test_ssd_kernel_calls_back_to_back(cuda):
    """Two calls in a row on the same stream, each zeroing its ticket and
    counts: the same bits (an item's result does not depend on which CTA
    took it or when), one launch each."""
    xbar, a, B, C = _ssd_cuda(cuda, 256, 4, 8, 2, 16)
    before = build.launch_counts()["ssd_scan"]
    first = ssd_scan(xbar, a, B, C, chunk=16)
    second = ssd_scan(xbar, a, B, C, chunk=16)
    torch.cuda.synchronize()
    assert build.launch_counts()["ssd_scan"] == before + 2
    assert torch.equal(first, second)
    np.testing.assert_allclose(first.cpu().numpy(),
                               ssd_scan_plain(xbar, a, B, C, 16)[0].cpu().numpy(),
                               rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
def test_ssd_kernel_in_a_cuda_graph(cuda):
    """One call captured in a CUDA graph (the counts' memset with it) and
    replayed twice: each replay equals an eager call bit for bit."""
    xbar, a, B, C = _ssd_cuda(cuda, 256, 4, 8, 2, 16)
    eager = ssd_scan(xbar, a, B, C, chunk=8)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssd_scan(xbar, a, B, C, chunk=8)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = build.launch_counts()["ssd_scan"]
    with torch.cuda.graph(graph):
        out = ssd_scan(xbar, a, B, C, chunk=8)
    assert build.launch_counts()["ssd_scan"] == before + 1
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("T,chunk,P,N", [(1024, 512, 16, 16), (256, 64, 128, 128)])
def test_ssd_kernel_tile_paths(cuda, T, chunk, P, N):
    """The kernel's other paths: a chunk of 512 (a scan in two blocks of
    256, 32 m-tiles a warp at a time, no warp pairs) and N = P = 128 (16
    state tiles, 8 of them formed after the wait; y in two passes of 64
    columns)."""
    from repro_torch.kernels.ssd_scan.kernel import sub_chunk

    assert sub_chunk(chunk, P, N) == chunk
    xbar, a, B, C = _ssd_cuda(cuda, T, 2, P, 1, N)
    y = ssd_scan(xbar, a, B, C, chunk=chunk)
    np.testing.assert_allclose(y.cpu().numpy(),
                               ssd_scan_plain(xbar, a, B, C, chunk)[0].cpu().numpy(),
                               rtol=3e-4, atol=3e-4)


@pytest.mark.cuda
def test_ssd_smem_bytes_match_the_kernel(cuda):
    """The wrapper's smem_bytes (which picks the sub-chunk) is the kernel's
    smem_floats, at the mamba2 shape and off the tiles."""
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    lib = build.library("ssd_scan", ssd_kernel._SIGNATURES)
    for q, p, n in [(128, 64, 128), (8, 8, 16), (100, 20, 12), (256, 7, 13), (64, 96, 40)]:
        assert lib.ssd_scan_smem_bytes(q, p, n) == ssd_kernel.smem_bytes(q, p, n)
    assert ssd_kernel.smem_bytes(128, 64, 128) == 215_168
