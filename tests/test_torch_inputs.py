"""Every input the JAX package's kernels take, taken by the port's kernels.

``repro``'s Pallas kernels cast their input to fp32, compute in fp32, write
in the input's dtype and bound no block size.  The port's kernels do the
same on the card: bfloat16 as well as float32, any block of the top-k
kernels (keys past a CTA's shared memory go to a device scratch buffer),
any K·D of kmeans_assign (centers walked in tiles) and any SSD chunk (a
chunk past shared memory runs as sub-chunks).

On the CPU each wrapper runs its plain version, held here against repro in
interpret mode on the same numpy inputs.  Tests marked ``cuda`` hold each
kernel at each newly taken input against its plain version on a card; they
skip elsewhere.  JAX is imported only inside the tests that compare with
repro, so ``pytest -m cuda`` runs on a GPU machine without JAX.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.sparse import block_layout  # noqa: E402
from repro_torch.data import kmeans_dataset  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.accumulate.fused_scatter import (  # noqa: E402
    fused_topk_scatter, fused_topk_scatter_plain, lanes)
from repro_torch.kernels.accumulate.kernel import (  # noqa: E402
    accumulate_blocked, accumulate_rows_unchecked)
from repro_torch.kernels.kmeans_assign.ops import (  # noqa: E402
    kmeans_assign, kmeans_assign_plain)
from repro_torch.kernels.ssd_scan.kernel import smem_bytes, ssd_scan, sub_chunk  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain  # noqa: E402
from repro_torch.kernels.topk_compress.ops import (  # noqa: E402
    ARGMAX_STATIC_SMEM, SELECT_STATIC_SMEM, topk_compress, topk_compress_plain, work_bytes)

SSD_TOL = {torch.float32: dict(rtol=3e-4, atol=3e-4),       # test_kernels.py:193
           torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}      # the repo's bf16 tolerance
# blocks past the old 1,024-lane limit and past the 16,384 lanes whose keys
# and fold accumulators fit shared memory; (V, k, block)
BIG_BLOCKS = [(20_000, 600, 2048), (50_000, 3000, 40_000)]


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


def _sparse(rng, shape, density=0.5):
    x = rng.normal(size=shape).astype(np.float32)
    x[rng.random(shape) >= density] = 0.0          # magnitude ties at zero
    return x


def _bf16(x: np.ndarray):
    """x rounded to bfloat16: (the torch tensor, its values as numpy fp32)."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, t.float().numpy()


def _np(t) -> np.ndarray:
    """A torch or JAX array as numpy float32 (bf16 values are exact in it)."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t).astype(np.float32)


def _jbf16(x32: np.ndarray):
    import jax.numpy as jnp
    return jnp.asarray(x32).astype(jnp.bfloat16)


# -- the CPU route against repro ------------------------------------------------


@pytest.mark.parametrize("n,v,k,block", [(4, 3000, 300, 1024), (3, 900, 900, 256),
                                         (2, 700, 40, 256)])
def test_fused_topk_scatter_bf16_vs_repro_interpret(n, v, k, block):
    """A bf16 round: selection on the fp32 magnitudes, the fold in fp32,
    one rounding to bf16 — bit-exact with repro's kernel."""
    from repro.kernels.accumulate.fused_scatter import fused_topk_scatter as j_fused

    x, x32 = _bf16(_sparse(np.random.default_rng(v), (n, v)))
    _, be, pb = block_layout(v, k, block)
    got = fused_topk_scatter(x, per_block=pb, block_eff=be)
    ref = j_fused(_jbf16(x32), per_block=pb, block_eff=be, interpret=True)
    assert got.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
    assert np.array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("v,k,block", BIG_BLOCKS)
def test_fused_topk_scatter_big_blocks_vs_repro_interpret(v, k, block):
    from repro.kernels.accumulate.fused_scatter import fused_topk_scatter as j_fused
    import jax.numpy as jnp

    x = _sparse(np.random.default_rng(block), (4, v), 0.3)
    _, be, pb = block_layout(v, k, block)
    assert be == block and pb < be
    got = fused_topk_scatter(torch.from_numpy(x), per_block=pb, block_eff=be)
    ref = j_fused(jnp.asarray(x), per_block=pb, block_eff=be, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("v,k,bv", [(900, 4, 256), (1000, 200, 256), (2048, 16, 512)])
def test_topk_compress_bf16_vs_both_pallas_bodies(v, k, bv):
    """Indices equal, values x's own bf16 elements, against each body."""
    from repro.kernels.topk_compress.kernel import topk_compress_blocked

    x, x32 = _bf16(_sparse(np.random.default_rng(v + k), (v,)))
    it, vt = topk_compress(x, k_per_block=k, block_v=bv)
    assert vt.dtype == torch.bfloat16
    for method in ("argmax", "bitonic"):
        ij, vj = topk_compress_blocked(_jbf16(x32), k_per_block=k, block_v=bv,
                                       interpret=True, method=method)
        assert np.array_equal(it.numpy(), np.asarray(ij)), method
        assert np.array_equal(_np(vt), _np(vj)), method


@pytest.mark.parametrize("v,k,block", BIG_BLOCKS)
def test_topk_compress_big_blocks_vs_both_pallas_bodies(v, k, block):
    from repro.kernels.topk_compress.kernel import topk_compress_blocked
    import jax.numpy as jnp

    x = _sparse(np.random.default_rng(block + 1), (v,), 0.3)
    _, be, pb = block_layout(v, k, block)
    it, vt = topk_compress(torch.from_numpy(x), k_per_block=pb, block_v=be)
    for method in ("argmax", "bitonic"):
        ij, vj = topk_compress_blocked(jnp.asarray(x), k_per_block=pb, block_v=be,
                                       interpret=True, method=method)
        assert np.array_equal(it.numpy(), np.asarray(ij)), method
        assert np.array_equal(vt.numpy(), np.asarray(vj)), method


def _assign_held(a, d, ja, jd, pts32):
    """Equal assignments; dist² within rtol 1e-5 plus 1e-6·max‖p‖²
    (tests/test_kernels.py's kmeans tolerance)."""
    assert np.array_equal(np.asarray(a), np.asarray(ja))
    np.testing.assert_allclose(np.asarray(d), np.asarray(jd), rtol=1e-5,
                               atol=1e-6 * float(np.max(np.sum(pts32 * pts32, axis=1))))


@pytest.mark.parametrize("n,d,k,seed", [(600, 8, 5, 1), (2000, 54, 7, 0)])
def test_kmeans_assign_bf16_vs_repro_interpret(n, d, k, seed):
    """bf16 points and centers, converted to fp32 on load: dist² in fp32."""
    from repro.kernels.kmeans_assign.kernel import kmeans_assign_blocked

    x, _, _ = kmeans_dataset(n, d, k, seed=seed)
    pts, pts32 = _bf16(x)
    ctr, ctr32 = _bf16(x[np.random.default_rng(seed).choice(n, k, replace=False)])
    a, dist = kmeans_assign(pts, ctr)
    assert a.dtype == torch.int32 and dist.dtype == torch.float32
    ja, jd = kmeans_assign_blocked(_jbf16(pts32), _jbf16(ctr32), block_n=256, interpret=True)
    _assign_held(a.numpy(), dist.numpy(), ja, jd, pts32)


def test_kmeans_assign_k1024_d64_vs_repro_interpret():
    """K 1,024 at D 64: 266 KB of centers, more than one CTA's shared memory
    (the kernel walks them in tiles)."""
    from repro.kernels.kmeans_assign.kernel import kmeans_assign_blocked
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    pts = rng.normal(size=(500, 64)).astype(np.float32)
    ctr = rng.normal(size=(1024, 64)).astype(np.float32)
    assert 1024 * 65 * 4 > build.MAX_SHARED_BYTES
    a, dist = kmeans_assign(torch.from_numpy(pts), torch.from_numpy(ctr))
    ja, jd = kmeans_assign_blocked(jnp.asarray(pts), jnp.asarray(ctr), block_n=256,
                                   interpret=True)
    _assign_held(a.numpy(), dist.numpy(), ja, jd, pts)


def _ssd_bh(rng, bh, t, p, n):
    x = (rng.normal(size=(bh, t, p)) * 0.5).astype(np.float32)
    a = -(np.abs(rng.normal(size=(bh, t))) * 0.05).astype(np.float32)
    bm = (rng.normal(size=(bh, t, n)) * 0.3).astype(np.float32)
    cm = (rng.normal(size=(bh, t, n)) * 0.3).astype(np.float32)
    return x, a, bm, cm


def test_ssd_scan_bf16_vs_repro_interpret():
    """bf16 xbar, B, C (a fp32): the state in fp32, y in bf16."""
    from repro.kernels.ssd_scan.kernel import ssd_scan_bh as j_scan
    import jax.numpy as jnp

    x, a, bm, cm = _ssd_bh(np.random.default_rng(8), 3, 64, 16, 32)
    (xt, x32), (bt, b32), (ct, c32) = _bf16(x), _bf16(bm), _bf16(cm)
    ref = j_scan(_jbf16(x32), jnp.asarray(a), _jbf16(b32), _jbf16(c32), chunk=16,
                 interpret=True)
    y = ssd_scan(xt[:, :, None], torch.from_numpy(a)[:, :, None], bt[:, :, None],
                 ct[:, :, None], chunk=16)[:, :, 0]
    assert y.dtype == torch.bfloat16 and str(ref.dtype) == "bfloat16"
    np.testing.assert_allclose(_np(y), _np(ref), **SSD_TOL[torch.bfloat16])


def test_ssd_scan_chunk256_vs_repro_interpret():
    """Chunk 256 at mamba2's P 64, N 128 needs 387 KB of shared memory: the
    kernel walks it as two sub-chunks of 128 with the state carried between
    them.  The plain version at chunk 256 and at that sub-chunk both agree
    with repro's kernel at chunk 256."""
    from repro.kernels.ssd_scan.kernel import ssd_scan_bh as j_scan
    import jax.numpy as jnp

    P, N = 64, 128
    assert smem_bytes(256, P, N) > build.MAX_SHARED_BYTES
    assert sub_chunk(256, P, N) == 128 and sub_chunk(128, P, N) == 128
    x, a, bm, cm = _ssd_bh(np.random.default_rng(9), 2, 512, P, N)
    ref = np.asarray(j_scan(*map(jnp.asarray, (x, a, bm, cm)), chunk=256, interpret=True))
    xb, ab, bb, cb = (torch.from_numpy(t)[:, :, None] for t in (x, a, bm, cm))
    for q in (256, sub_chunk(256, P, N)):
        y = ssd_scan_plain(xb, ab, bb, cb, q)[0][:, :, 0]
        np.testing.assert_allclose(y.numpy(), ref, **SSD_TOL[torch.float32])
    y = ssd_scan(xb, ab, bb, cb, chunk=256)[:, :, 0]
    np.testing.assert_allclose(y.numpy(), ref, **SSD_TOL[torch.float32])


def test_sub_chunk_is_the_largest_divisor_that_fits():
    for chunk, P, N in [(128, 64, 128), (256, 64, 128), (384, 64, 128), (100, 64, 128),
                        (512, 32, 64), (8, 8, 16)]:
        q = sub_chunk(chunk, P, N)
        assert chunk % q == 0 and smem_bytes(q, P, N) <= build.MAX_SHARED_BYTES
        assert all(chunk % r or smem_bytes(r, P, N) > build.MAX_SHARED_BYTES
                   for r in range(q + 1, chunk + 1))


def test_dtype_code_takes_float32_and_bfloat16_only():
    """The C dtype code of the kernels' inputs; any other dtype, or inputs
    of two dtypes, raise rather than fall back."""
    f32, bf16 = torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16)
    assert build.dtype_code("k", f32, f32) == 0 and build.dtype_code("k", bf16) == 1
    with pytest.raises(TypeError, match="the k kernel takes float32 or bfloat16"):
        build.dtype_code("k", f32.half())
    with pytest.raises(TypeError, match="one dtype"):
        build.dtype_code("k", f32, bf16)


def test_working_sets_past_shared_memory_take_scratch():
    """A block's keys and fold accumulators (fused: 12 bytes a lane), the
    selected keys (bitonic: 8 a key, padded to a power of two) or magnitudes
    (argmax: 4 an entry) stay in shared memory up to 16,384 lanes, 16,384
    keys — whatever the block — and 58,048 entries."""
    assert lanes(16_384) == 16_384 and lanes(16_385) == 32_768 and lanes(7) == 8
    assert 12 * lanes(16_384) <= build.MAX_SHARED_BYTES < 12 * lanes(16_385)
    assert work_bytes(16_384, 16_384, "bitonic") + SELECT_STATIC_SMEM <= build.MAX_SHARED_BYTES
    assert work_bytes(65_536, 16_385, "bitonic") > build.MAX_SHARED_BYTES
    assert work_bytes(1024, 7, "bitonic") == 8 * 8
    assert build.scratch(work_bytes(65_536, 100, "bitonic"), 4, "cpu", SELECT_STATIC_SMEM) is None
    assert build.scratch(work_bytes(58_048, 1, "argmax"), 3, "cpu", ARGMAX_STATIC_SMEM) is None
    buf = build.scratch(work_bytes(58_049, 1, "argmax"), 3, "cpu", ARGMAX_STATIC_SMEM)
    assert buf.numel() == 3 * 4 * 58_049


# -- one bf16 SPARSE accumulator round, fused and unfused, block 2048 -------------


def _bf16_round(pkg, vecs, k, block, fused):
    """One accumulator round of bf16 contributions arriving in list order."""
    if pkg == "jax":
        import jax.numpy as jnp
        from repro.core import AccumMode, DAddAccumulator, GlobalStore
        store, conv = GlobalStore(), lambda v: jnp.asarray(v).astype(jnp.bfloat16)
    else:
        from repro_torch.core import AccumMode, DAddAccumulator, GlobalStore
        store, conv = GlobalStore(device="cpu"), lambda v: torch.from_numpy(v).to(
            torch.bfloat16)
    store.new_array("out", vecs[0].shape)
    acc = DAddAccumulator(store, "out", len(vecs), 2, AccumMode.SPARSE, k=k, block=block,
                          fused=fused)
    threads = []
    for i, v in enumerate(vecs):
        threads.append(threading.Thread(target=acc.accumulate, args=(conv(v),)))
        threads[-1].start()
        deadline = time.time() + 10
        while acc._count < i + 1 and i + 1 < len(vecs) and time.time() < deadline:
            time.sleep(0.001)
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    return store.get("out"), acc


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_bf16_sparse_round_block2048_vs_repro(fused):
    """A bf16 SPARSE round with blocks of 2,048 (past the old 1,024 limit):
    the same bits, wire count and pair counts as repro's round."""
    rng = np.random.default_rng(12)
    vecs = [_bf16(_sparse(rng, (6000,), 0.2))[1] for _ in range(4)]
    oj, aj = _bf16_round("jax", vecs, 1500, 2048, fused)
    ot, at = _bf16_round("torch", vecs, 1500, 2048, fused)
    assert ot.dtype == torch.bfloat16
    assert np.array_equal(_np(ot), _np(oj))
    assert at.bytes_transferred == aj.bytes_transferred
    assert at.last_pair_counts == aj.last_pair_counts


# -- on the card: each kernel at each newly taken input against its plain version --


def _launched(name, fn):
    before = build.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert build.launch_counts()[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,v,k,block", [(4, 16384, 512, 1024), (3, 900, 900, 256),
                                         (4, 30_000, 3000, 2048), (4, 40_000, 4000, 16_384),
                                         (2, 150_000, 9000, 65_536), (3, 70_000, 70_000, 65_536)])
def test_fused_topk_scatter_kernel_inputs(cuda, dtype, n, v, k, block):
    """bf16, and blocks of 2,048 and 16,384 (shared memory) and 65,536
    (device scratch): bit-exact with the plain version."""
    rng = np.random.default_rng(block)
    _, be, pb = block_layout(v, k, block)
    for density in (0.01, 0.3, 1.0):
        x = torch.from_numpy(_sparse(rng, (n, v), density)).to(cuda, dtype)
        got = _launched("fused_topk_scatter",
                        lambda: fused_topk_scatter(x, per_block=pb, block_eff=be))
        assert got.dtype == dtype
        assert torch.equal(got, fused_topk_scatter_plain(x, pb, be)), density


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("v,k,bv", [(4096, 256, 1024), (2048, 16, 512), (30_000, 40, 2048),
                                    (40_000, 300, 16_384), (150_000, 24, 65_536),
                                    (200_000, 100, 65_536)])
def test_topk_compress_kernels_inputs(cuda, dtype, v, k, bv):
    """Both bodies at bf16 and at blocks of 2,048, 16,384 and 65,536 (the
    argmax body's magnitudes go to scratch past 58,048 entries; the bitonic
    body re-reads x on each pass past 16,384 lanes): bit-exact with the
    plain version."""
    x = torch.from_numpy(_sparse(np.random.default_rng(v), (v,))).to(cuda, dtype)
    pi, pv = topk_compress_plain(x, k, min(bv, v))
    for method in ("argmax", "bitonic"):
        i, val = _launched(f"topk_compress_{method}",
                           lambda: topk_compress(x, k_per_block=k, block_v=bv, method=method))
        assert val.dtype == dtype
        assert torch.equal(i, pi) and torch.equal(val, pv), method


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,d,k", [(145_253, 54, 7), (20_000, 64, 1024), (3000, 8, 9000),
                                   (300, 60_000, 3)])
def test_kmeans_assign_kernel_inputs(cuda, dtype, n, d, k):
    """bf16; K 1,024 at D 64 (centers in tiles); K 9,000 (many tiles); D
    60,000 (no center row fits: rows read from device memory).  At D 60,000
    the kernel's sequential FMA chains and the plain version's matrix
    product round far apart (each ~60,000 terms), so that case takes
    integer-valued points in {-1, 0, 1}: every partial sum is exact in fp32
    and the two must agree exactly."""
    rng = np.random.default_rng(d)
    if d > 10_000:
        x = rng.integers(-1, 2, size=(n, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
    pts = torch.from_numpy(x).to(cuda, dtype)
    ctr = pts[rng.choice(n, k, replace=n < k)].clone()
    a, dist = _launched("kmeans_assign", lambda: kmeans_assign(pts, ctr))
    pa, pd = kmeans_assign_plain(pts, ctr)
    if d > 10_000:
        assert torch.equal(a, pa) and torch.equal(dist, pd)
    p32 = pts.float()
    diff = a.long() != pa.long()
    if bool(diff.any()):   # only where the two best d² tie within rounding
        d2 = ((p32[diff, None, :] - ctr.float()[None]) ** 2).sum(-1)
        two = torch.topk(d2, 2, dim=1, largest=False).values
        assert bool(((two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 1].abs()).all())
    torch.testing.assert_close(dist, pd, rtol=1e-5,
                               atol=1e-6 * float((p32 * p32).sum(1).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,chunk,H,G,P,N", [
    (torch.bfloat16, 8, 4, 2, 8, 16), (torch.bfloat16, 128, 3, 1, 64, 128),
    (torch.float32, 256, 3, 1, 64, 128), (torch.bfloat16, 256, 3, 1, 64, 128)])
def test_ssd_kernel_inputs(cuda, dtype, chunk, H, G, P, N):
    """bf16 xbar/B/C within 3e-2, chunk 256 (two sub-chunks of 128) within
    3e-4 in fp32, of the plain version at the same chunk."""
    rng = np.random.default_rng(chunk)
    t = 512
    xbar = torch.from_numpy((rng.normal(size=(2, t, H, P)) * 0.5).astype(np.float32))
    a = -torch.from_numpy((np.abs(rng.normal(size=(2, t, H))) * 0.05).astype(np.float32))
    bm, cm = (torch.from_numpy((rng.normal(size=(2, t, G, N)) * 0.3).astype(np.float32))
              for _ in range(2))
    xbar, bm, cm = (z.to(cuda, dtype) for z in (xbar, bm, cm))
    a = a.to(cuda)
    y = _launched("ssd_scan", lambda: ssd_scan(xbar, a, bm, cm, chunk=chunk))
    assert y.dtype == dtype
    ref = ssd_scan_plain(xbar, a, bm, cm, chunk)[0]
    torch.testing.assert_close(y.float(), ref.float(), **SSD_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("n,v", [(4, 1_141_376), (4, 1001), (70, 3000)])
def test_accumulate_unchecked_entry_same_bits(cuda, n, v):
    """The accumulator's entry (no row checks, no device switch on the
    current device) and the public wrapper launch the same kernel: the
    same bits, one launch each."""
    rows = [torch.from_numpy(r).to(cuda) for r in
            np.random.default_rng(v).normal(size=(n, v)).astype(np.float32)]
    got = _launched("accumulate_blocked", lambda: accumulate_rows_unchecked(rows))
    ref = _launched("accumulate_blocked", lambda: accumulate_blocked(rows))
    assert torch.equal(got, ref)
    assert torch.equal(got, _launched("accumulate_blocked",
                                      lambda: accumulate_blocked(torch.stack(rows))))
