"""The accumulator's receive-side kernels: accumulate_blocked and
sparse_scatter_add.

Their plain versions against repro's Pallas kernels in interpret mode and
against repro's oracles, on the same numpy inputs; the CPU route and the
wrappers' validation; and (on a card) each CUDA kernel against its plain
version.  Tests marked ``cuda`` need an NVIDIA GPU with nvcc and skip
elsewhere; JAX is imported only inside the tests that compare with repro.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.sparse import blocked_topk_sparsify  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.accumulate import ops as acc_ops  # noqa: E402
from repro_torch.kernels.accumulate.kernel import accumulate_blocked  # noqa: E402
from repro_torch.kernels.accumulate.ref import accumulate_plain  # noqa: E402
from repro_torch.kernels.sparse_update import ops as sc_ops  # noqa: E402
from repro_torch.kernels.sparse_update.kernel import sparse_scatter_add  # noqa: E402
from repro_torch.kernels.sparse_update.ref import sparse_scatter_add_plain  # noqa: E402


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


# the JAX package's kernel-test sweeps (tests/test_kernels.py) and tolerances
ACC_SHAPES = [(4, 1024, 256), (7, 3000, 512), (1, 128, 128)]
SCATTER_SHAPES = [(50, 700, 256), (200, 4096, 1024), (1, 64, 64)]
SCATTER_TOL = dict(rtol=1e-5, atol=1e-6)


def _tol(dtype):
    return dict(rtol=3e-2, atol=3e-2) if dtype == torch.bfloat16 else dict(rtol=3e-5, atol=3e-5)


def _left_fold(x: np.ndarray) -> np.ndarray:
    acc = x[0].copy()
    for row in x[1:]:
        acc = acc + row
    return acc


# -- accumulate_blocked ------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,v,bv", ACC_SHAPES)
def test_accumulate_plain_vs_repro_interpret(dtype, n, v, bv):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.accumulate.kernel import accumulate_blocked as j_accumulate
    from repro.kernels.accumulate.ref import accumulate_ref

    x = np.random.default_rng(2).normal(size=(n, v)).astype(np.float32)
    jx = jnp.asarray(x, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(dtype)
    got = acc_ops.accumulate(tx, block_v=bv)
    assert got.dtype == dtype and got.shape == (v,)
    want = np.asarray(j_accumulate(jx, block_v=bv, interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dtype))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(accumulate_ref(jx), np.float32),
                               **_tol(dtype))
    assert torch.equal(acc_ops.accumulate(list(tx), block_v=bv), got)   # the rows form
    if dtype == torch.float32:
        assert np.array_equal(got.numpy(), _left_fold(x))


def test_accumulate_is_a_new_tensor_and_keeps_signed_zero():
    """One row: a copy of it (never a view), -0.0 kept as the fold keeps it."""
    row = torch.tensor([-0.0, 1.0, -2.5])
    out = accumulate_blocked([row])
    assert torch.equal(out, row) and out.data_ptr() != row.data_ptr()
    assert torch.signbit(out[0])


# -- sparse_scatter_add ------------------------------------------------------


@pytest.mark.parametrize("m,v,bv", SCATTER_SHAPES)
def test_scatter_add_plain_vs_repro(m, v, bv):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.sparse_update.kernel import sparse_scatter_add as j_scatter
    from repro.kernels.sparse_update.ref import sparse_scatter_add_ref

    rng = np.random.default_rng(4)
    idx = rng.integers(0, v, size=(m,)).astype(np.int32)
    vals = rng.normal(size=(m,)).astype(np.float32)
    got = sc_ops.scatter_add(torch.from_numpy(idx), torch.from_numpy(vals), out_len=v,
                             block_v=bv)
    assert got.dtype == torch.float32 and got.shape == (v,)
    want = j_scatter(jnp.asarray(idx), jnp.asarray(vals), v, block_v=bv, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCATTER_TOL)
    oracle = sparse_scatter_add_ref(jnp.asarray(idx), jnp.asarray(vals), v)
    assert np.array_equal(got.numpy(), np.asarray(oracle))


def test_scatter_add_duplicates():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.sparse_update.kernel import sparse_scatter_add as j_scatter

    idx, vals = [3, 3, 3, 0], [1.0, 2.0, 3.0, 5.0]
    got = sparse_scatter_add(torch.tensor(idx, dtype=torch.int32), torch.tensor(vals), 8,
                             block_v=8)
    assert float(got[3]) == 6.0 and float(got[0]) == 5.0
    want = j_scatter(jnp.asarray(idx, jnp.int32), jnp.asarray(vals, jnp.float32), 8,
                     block_v=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCATTER_TOL)


@pytest.mark.parametrize("bv", [4, 8])
def test_scatter_add_drops_out_of_range(bv):
    """Indices outside [0, out_len) are dropped, negatives included, as the
    TPU kernel's ``inside`` mask drops them."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.sparse_update.kernel import sparse_scatter_add as j_scatter

    idx = np.array([-1, 0, 7, 8, 100, 3, -5], np.int32)
    vals = np.array([10.0, 1.0, 2.0, 30.0, 40.0, 4.0, 50.0], np.float32)
    got = sparse_scatter_add(torch.from_numpy(idx), torch.from_numpy(vals), 8, block_v=bv)
    want = np.zeros(8, np.float32)
    want[[0, 7, 3]] = [1.0, 2.0, 4.0]
    assert np.array_equal(got.numpy(), want)
    j = j_scatter(jnp.asarray(idx), jnp.asarray(vals), 8, block_v=bv, interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(j))


def test_scatter_add_rows_in_row_order():
    """A (T, P) pair matrix is its rows applied in row order: the oracle's
    sequential scatter of the row-major flattening, bit for bit, and one
    int64 index set gives the same as int32."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.sparse_update.ref import sparse_scatter_add_ref

    rng = np.random.default_rng(5)
    idx = rng.integers(0, 300, size=(4, 120)).astype(np.int32)
    vals = rng.normal(size=(4, 120)).astype(np.float32)
    got = sc_ops.scatter_add(torch.from_numpy(idx), torch.from_numpy(vals), out_len=300)
    oracle = sparse_scatter_add_ref(jnp.asarray(idx.reshape(-1)),
                                    jnp.asarray(vals.reshape(-1)), 300)
    assert np.array_equal(got.numpy(), np.asarray(oracle))
    wide = sc_ops.scatter_add(torch.from_numpy(idx).long(), torch.from_numpy(vals), out_len=300)
    assert torch.equal(wide, got)


def test_scatter_add_bf16_sums_in_fp32():
    """Three adds of 2^-9 to 1.0 each round away in bf16, but their fp32 sum
    1 + 3·2^-9 rounds once, to 1 + 2^-7."""
    idx = torch.tensor([1, 1, 1, 1, 2], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0 ** -9, 2.0 ** -9, 2.0 ** -9, 3.0], dtype=torch.bfloat16)
    got = sparse_scatter_add(idx, vals, 4)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, sparse_scatter_add(idx, vals.float(), 4).to(torch.bfloat16))
    assert got.tolist() == [0.0, 1.0 + 2.0 ** -7, 3.0, 0.0]


# -- both: the CPU route and validation --------------------------------------


def test_cpu_tensors_take_the_plain_route():
    """A CPU tensor runs the plain version and never touches a counter."""
    build.reset_launches()
    x = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    assert torch.equal(accumulate_blocked(x), accumulate_plain(x))
    idx = torch.randint(0, 50, (2, 10), generator=torch.Generator().manual_seed(1))
    assert torch.equal(sparse_scatter_add(idx, x[:2, :10], 50),
                       sparse_scatter_add_plain(idx, x[:2, :10], 50))
    counts = build.launch_counts()
    assert counts["accumulate_blocked"] == 0 and counts["sparse_scatter_add"] == 0


def test_wrapper_validation():
    with pytest.raises(ValueError, match=r"\(N, V\)"):
        accumulate_blocked(torch.zeros(8))
    with pytest.raises(ValueError, match="at least one row"):
        accumulate_blocked([])
    with pytest.raises(ValueError, match="differ"):
        accumulate_blocked([torch.zeros(8), torch.zeros(7)])
    with pytest.raises(ValueError, match="block_v"):
        accumulate_blocked(torch.zeros(2, 8), block_v=0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        accumulate_blocked(torch.zeros(2, 8, device="meta"))
    with pytest.raises(ValueError, match="one shape"):
        sparse_scatter_add(torch.zeros(3, dtype=torch.int32), torch.zeros(4), 8)
    with pytest.raises(ValueError, match="out_len"):
        sparse_scatter_add(torch.zeros(3, dtype=torch.int32), torch.zeros(3), -1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        sparse_scatter_add(torch.zeros(3, dtype=torch.int32, device="meta"),
                           torch.zeros(3, device="meta"), 8)


# -- on the card: each CUDA kernel against its plain version -----------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,v,bv", ACC_SHAPES + [(70, 1001, 1024), (4, 4_847_571, 1024)])
def test_accumulate_kernel(cuda, dtype, n, v, bv):
    """Bit-exact in float32 (the (N, V) form, the rows form, and more rows
    than the kernel takes by pointer); within the bf16 tolerance in bf16."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(n, v)).astype(np.float32))
    x = x.to(cuda).to(dtype)
    before = build.launch_counts()["accumulate_blocked"]
    outs = [accumulate_blocked(x, block_v=bv), accumulate_blocked(list(x), block_v=bv),
            accumulate_blocked([r.clone() for r in x], block_v=bv)]
    torch.cuda.synchronize()
    assert build.launch_counts()["accumulate_blocked"] == before + 3
    ref = accumulate_plain(x)
    for out in outs:
        if dtype == torch.float32:
            assert torch.equal(out, ref)
        else:
            torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4, 70])
@pytest.mark.parametrize("m,v,bv", SCATTER_SHAPES)
def test_scatter_add_kernel_sweep(cuda, rows, m, v, bv):
    """Random indices collide inside each row: held to the stated tolerance,
    one launch per call for 1, 4 and 70 rows."""
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(0, v, size=(rows, m)).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.normal(size=(rows, m)).astype(np.float32)).to(cuda)
    if rows == 1:
        idx, vals = idx[0], vals[0]
    before = build.launch_counts()["sparse_scatter_add"]
    got = sparse_scatter_add(idx, vals, v, block_v=bv)
    torch.cuda.synchronize()
    assert build.launch_counts()["sparse_scatter_add"] == before + 1
    torch.testing.assert_close(got, sparse_scatter_add_plain(idx, vals, v), **SCATTER_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("v,k,rows", [(512, 32, 4), (100_000, 25_000, 4), (5000, 1200, 3),
                                      (1030, 600, 1), (1030, 600, 70),
                                      (4_847_571, 1_211_892, 4)])
def test_scatter_add_kernel_bitexact_on_pairs(cuda, dtype, index_dtype, v, k, rows):
    """The accumulator's pairs (unique indices per row apart from (0, 0.0)
    padding; (1030, 600) pads its last block, the last case is pagerank's
    unfused round), rows added in order: bit-exact with either index dtype,
    in float32 and in bfloat16 (the fp32 sum cast once, inside the launch),
    one launch per call whatever the number of rows."""
    rng = np.random.default_rng(6)
    pairs = []
    for _ in range(rows):
        x = rng.normal(size=(v,)).astype(np.float32)
        x[rng.random(v) < 0.7] = 0.0
        pairs.append(blocked_topk_sparsify(torch.from_numpy(x).to(cuda, dtype), k))
    idx = torch.stack([p.idx for p in pairs]).to(index_dtype)
    vals = torch.stack([p.vals for p in pairs])
    before = build.launch_counts()["sparse_scatter_add"]
    got = sparse_scatter_add(idx, vals, v)
    torch.cuda.synchronize()
    assert build.launch_counts()["sparse_scatter_add"] == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, sparse_scatter_add_plain(idx, vals, v))
