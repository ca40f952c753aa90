"""repro_torch.core.sparse and its kernels' plain versions against repro.

Same numpy inputs through both packages; selection, pair streams and the
fused accumulate must be bit-exact (the JAX side runs its Pallas kernels in
interpret mode, or its jnp references).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.sparse as J  # noqa: E402
import repro_torch.core.sparse as T  # noqa: E402
from repro.kernels.bitonic import bitonic_sort_desc  # noqa: E402
from repro.kernels.topk_compress.kernel import topk_compress_blocked  # noqa: E402
from repro_torch.kernels.bitonic import key_pos, sort_desc, topk_keys  # noqa: E402
from repro_torch.kernels.topk_compress.ops import BITONIC_MIN_K, topk_compress  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    torch's default of one thread per core would oversubscribe the CPU
    under the timing-sensitive tests of other files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vec(rng, v, zero_frac=0.5):
    x = rng.normal(size=(v,)).astype(np.float32)
    x[rng.random(v) < zero_frac] = 0.0          # magnitude ties at zero
    return x


@pytest.mark.parametrize("n,k,block", [
    (1, 1, 1024), (7, 3, 1024), (100, 10, 1024), (900, 4, 256), (1000, 50, 256),
    (4096, 256, 1024), (16384, 512, 1024), (4_847_571, 1_211_892, 1024), (64, 1000, 16),
])
def test_layout_functions_equal(n, k, block):
    assert T.block_layout(n, k, block) == J.block_layout(n, k, block)
    assert T.pair_capacity(n, k, block) == J.pair_capacity(n, k, block)
    assert T.default_auto_k(n) == J.default_auto_k(n)


@pytest.mark.parametrize("n,k", [(0, 4), (8, 0), (-1, 2)])
def test_layout_rejects_what_repro_rejects(n, k):
    with pytest.raises(ValueError) as tj:
        J.block_layout(n, k)
    with pytest.raises(ValueError) as tt:
        T.block_layout(n, k)
    assert str(tj.value) == str(tt.value)


@pytest.mark.parametrize("v,k,bv", [(900, 4, 256), (2048, 16, 512), (100, 2, 64),
                                    (1000, 200, 256), (4096, 256, 1024)])
def test_topk_compress_bitexact_vs_both_pallas_bodies(v, k, bv):
    """The pair stream of the port (CPU: the plain version both CUDA bodies
    are held against) equals each Pallas body's, element for element."""
    x = _vec(np.random.default_rng(7), v)
    it, vt = topk_compress(torch.from_numpy(x), k_per_block=k, block_v=bv)
    assert it.dtype == torch.int32
    for method in ("argmax", "bitonic"):
        ij, vj = topk_compress_blocked(jnp.asarray(x), k_per_block=k, block_v=bv,
                                       interpret=True, method=method)
        assert np.array_equal(it.numpy(), np.asarray(ij)), method
        assert np.array_equal(vt.numpy(), np.asarray(vj)), method
    for method in ("argmax", "bitonic"):   # the CPU route ignores the body
        i2, v2 = topk_compress(torch.from_numpy(x), k_per_block=k, block_v=bv,
                               method=method)
        assert torch.equal(i2, it) and torch.equal(v2, vt)


@pytest.mark.parametrize("v,k,block", [(900, 16, 256), (1000, 200, 256),
                                       (4096, 4 * BITONIC_MIN_K, 1024), (7, 3, 1024),
                                       (2048, 2048, 512)])
def test_blocked_topk_sparsify_bitexact(v, k, block):
    """Both port impls against repro's interpret-mode kernel and jnp path,
    including per_block >= BITONIC_MIN_K and quota >= block."""
    x = _vec(np.random.default_rng(v + k), v)
    refs = [J.blocked_topk_sparsify(jnp.asarray(x), k, block, impl="jnp")]
    if v < 2048:   # the Pallas bodies at large blocks: covered kernel-level above
        refs.append(J.blocked_topk_sparsify(jnp.asarray(x), k, block, impl="pallas"))
    for impl in ("kernel", "torch"):
        got = T.blocked_topk_sparsify(torch.from_numpy(x), k, block, impl=impl)
        for ref in refs:
            assert got.n == ref.n and got.num_pairs == ref.num_pairs
            assert np.array_equal(got.idx.numpy(), np.asarray(ref.idx)), impl
            assert np.array_equal(got.vals.numpy(), np.asarray(ref.vals)), impl


@pytest.mark.parametrize("v,k,block", [(1000, 40, 256), (1001, 200, 256), (7, 3, 1024),
                                       (5000, 300, 2048), (70, 70, 16)])
def test_kernel_pairs_need_no_normalisation(v, k, block):
    """impl="kernel" hands on topk_compress's pairs as they are: past the
    vector they are already (0, 0), so on lengths that are no multiple of
    the block they equal the pairs normalised as impl="torch" normalises
    its own (index past n -> 0, value -> 0)."""
    x = _vec(np.random.default_rng(v + k), v)
    x[::7] *= -1.0
    t = torch.from_numpy(x)
    got = T.blocked_topk_sparsify(t, k, block)
    _, be, pb = T.block_layout(v, k, block)
    idx, vals = topk_compress(t, k_per_block=pb, block_v=be)
    in_range = idx < v
    assert got.n == v and got.idx.dtype == torch.int32
    assert torch.equal(got.idx, torch.where(in_range, idx, 0).to(torch.int32))
    assert torch.equal(got.vals.view(torch.int32),
                       torch.where(in_range, vals, torch.zeros(())).view(torch.int32))
    assert bool((got.idx < v).all())
    ref = T.blocked_topk_sparsify(t, k, block, impl="torch")
    assert torch.equal(got.idx, ref.idx) and torch.equal(got.vals, ref.vals)


@pytest.mark.parametrize("n,v,k,block", [
    (4, 16384, 512, 1024),     # the accumulator bench shape
    (8, 1000, 50, 256),        # ragged tail
    (1, 100, 10, 1024),        # single thread, one short block
    (3, 900, 900, 256),        # quota >= block: selection degenerates to all
    (2, 7, 3, 1024),           # tiny vector, non-pow2 block
])
def test_blocked_topk_accumulate_bitexact(n, v, k, block):
    """Fused and unfused, both impls, bit-exact against repro's compress→
    densify→add and its fused reference, across densities."""
    rng = np.random.default_rng(9)
    for density in (0.0, 0.01, 0.3, 1.0):
        mat = rng.normal(size=(n, v)).astype(np.float32)
        mat[rng.random((n, v)) >= density] = 0.0
        ref = np.asarray(J.blocked_topk_accumulate(jnp.asarray(mat), k, block,
                                                   fused=False, impl="jnp"))
        ref_f = np.asarray(J.blocked_topk_accumulate(jnp.asarray(mat), k, block,
                                                     fused=True, impl="jnp"))
        assert np.array_equal(ref, ref_f)
        tm = torch.from_numpy(mat)
        for fused in (True, False):
            for impl in ("kernel", "torch"):
                got = T.blocked_topk_accumulate(tm, k, block, fused=fused, impl=impl)
                assert np.array_equal(got.numpy(), ref), (density, fused, impl)


def test_fused_accumulate_matches_pallas_interpret():
    """One shape through repro's interpret-mode fused kernel itself."""
    rng = np.random.default_rng(11)
    mat = rng.normal(size=(4, 2000)).astype(np.float32)
    mat[rng.random(mat.shape) < 0.7] = 0.0
    ref = np.asarray(J.blocked_topk_accumulate(jnp.asarray(mat), 300, 512,
                                               fused=True, impl="pallas"))
    got = T.blocked_topk_accumulate(torch.from_numpy(mat), 300, 512)
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("v,k,block", [(1024, 8, 1024), (1000, 50, 256), (64, 32, 16),
                                       (1, 1, 1024), (3000, 600, 1024)])
def test_sparse_beneficial_same_answers(v, k, block):
    rng = np.random.default_rng(v)
    rows = []
    for density in (0.0, 0.005, 0.02, 0.1, 0.5, 1.0):
        x = rng.normal(size=(v,)).astype(np.float32)
        x[rng.random(v) >= density] = 0.0
        rows.append(x)
        assert bool(T.sparse_beneficial(torch.from_numpy(x), k, block)) == \
            bool(J.sparse_beneficial(jnp.asarray(x), k, block)), density
    for batch in (rows[:2], rows[:3], rows, [rows[0]] * 4):
        assert bool(T.sparse_beneficial_batch([torch.from_numpy(r) for r in batch],
                                              k, block)) == \
            bool(J.sparse_beneficial_batch(batch, k, block))


def test_bitonic_key_order_matches_repro_network():
    """The packed keys sort exactly as repro's bitonic network orders
    (mag desc, idx asc): magnitude ties (zeros, repeated values, +0/-0),
    invalid lanes (-1) and pad lanes (-inf) past the block."""
    rng = np.random.default_rng(3)
    length, block_eff = 24, 20                      # lanes 20..23 are pad lanes
    x = rng.choice(np.array([0.0, -0.0, 1.5, -1.5, 2.0, 0.25], np.float32), size=length)
    valid = np.arange(length) < 17                  # lanes 17..19 are invalid
    mag = np.where(valid, np.abs(x), -1.0).astype(np.float32)
    mag[block_eff:] = -np.inf
    _, order = jax.jit(bitonic_sort_desc)(jnp.asarray(mag),
                                          jnp.arange(length, dtype=jnp.int32))
    keys = topk_keys(torch.from_numpy(x), torch.from_numpy(valid))
    got = key_pos(sort_desc(keys))
    assert np.array_equal(got.numpy(), np.asarray(order))
    # sentinel ranks: every valid lane, then invalid, then pad
    assert list(got.numpy()[17:20]) == [17, 18, 19]
    assert list(got.numpy()[20:]) == [20, 21, 22, 23]


def test_pairs_format_and_densify():
    x = np.zeros(300, np.float32)
    x[[3, 100, 299]] = [1.0, -2.0, 0.5]
    p = T.blocked_topk_sparsify(torch.from_numpy(x), 8, 128)
    idx, vals = p                                    # tuple-style call sites
    assert p.num_pairs == T.pair_capacity(300, 8, 128) == idx.shape[0]
    assert p.wire_elements == 2 * p.num_pairs
    assert np.array_equal(p.densify().numpy(), x)
    ref = J.densify(jnp.asarray(idx.numpy()), jnp.asarray(vals.numpy()), 300)
    assert np.array_equal(T.densify(idx, vals, 300).numpy(), np.asarray(ref))


@pytest.mark.parametrize("v,k,rows", [(300, 8, 4), (5000, 1200, 3), (1000, 50, 1)])
def test_densify_pair_rows_bitexact(v, k, rows):
    """(T, P) pairs of real compressions (overlapping across rows, unique
    within a row apart from (0, 0.0) padding), and the flat 1-D form: the
    same bits as repro's densify, which scatters thread 0's pairs first."""
    rng = np.random.default_rng(v)
    pairs = [T.blocked_topk_sparsify(torch.from_numpy(_vec(rng, v, 0.6)), k)
             for _ in range(rows)]
    idx = torch.stack([p.idx for p in pairs])
    vals = torch.stack([p.vals for p in pairs])
    ref = np.asarray(J.densify(jnp.asarray(idx.numpy()), jnp.asarray(vals.numpy()), v))
    assert np.array_equal(T.densify(idx, vals, v).numpy(), ref)
    assert np.array_equal(T.densify(idx.reshape(-1), vals.reshape(-1), v).numpy(), ref)


def test_densify_bf16_adds_in_bf16_as_repro():
    """Non-float32 pairs keep repro's scatter in their own type."""
    idx = np.array([[1, 1, 1, 1, 2]], np.int32)
    vals = np.array([[1.0, 2.0 ** -9, 2.0 ** -9, 2.0 ** -9, 3.0]], np.float32)
    got = T.densify(torch.from_numpy(idx), torch.from_numpy(vals).to(torch.bfloat16), 4)
    ref = J.densify(jnp.asarray(idx), jnp.asarray(vals, jnp.bfloat16), 4)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    assert got.tolist() == [0.0, 1.0, 3.0, 0.0]


@pytest.mark.parametrize("v,k", [(1, 1), (100, 10), (1000, 200), (64, 64)])
def test_topk_sparsify_bitexact(v, k):
    """The unblocked form: indices and values equal to repro's, ties at zero
    and at equal magnitudes broken toward the lower index."""
    x = _vec(np.random.default_rng(k), v)
    x[: v // 10] = np.abs(x[: v // 10])
    x[v // 10: v // 5] = -np.abs(x[: v // 10][: v // 5 - v // 10])   # ± ties
    ti, tv = T.topk_sparsify(torch.from_numpy(x), k)
    ji, jv = J.topk_sparsify(jnp.asarray(x), k)
    assert ti.dtype == torch.int32
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(ValueError, match="k must lie"):
        T.topk_sparsify(torch.from_numpy(x), v + 1)


def test_impl_and_method_validation():
    x = torch.zeros(16)
    with pytest.raises(ValueError, match="kernel|torch"):
        T.blocked_topk_sparsify(x, 4, impl="pallas")
    with pytest.raises(ValueError, match="kernel|torch"):
        T.blocked_topk_accumulate(x.reshape(2, 8), 4, impl="jnp")
    with pytest.raises(ValueError, match="argmax|bitonic"):
        topk_compress(x, k_per_block=2, method="quicksort")
    with pytest.raises(ValueError, match="exceeds the block size"):
        topk_compress(x, k_per_block=17)
    with pytest.raises(ValueError, match="1-D"):
        topk_compress(x.reshape(2, 8), k_per_block=2)
