"""kmeans_assign's CUDA kernel, its algorithm run on the CPU.

The kernel (``csrc/kmeans_assign.cu``) runs only on a card.  This file
carries out its three bodies' steps in numpy, with the kernel's layout:

- rows: tiles of 128 consecutive points, loaded as one flat run of
  elements (the head before the pointer's first 16-byte boundary and the
  tail element by element, 16-byte vectors between), each element put at
  row e / d (a float estimate, corrected by one) and column e % d of a tile
  whose rows sit at an odd stride; K padded with zero centers to 8 or 16;
  each point's |p|², dots and the centers' norms as fp32 FMA chains in j
  order; the first minimum by a strict < in center order;
- tiles: BP points a CTA (64, 8 x 8 dots a thread, where that gives 264
  CTAs; else 16, 4 x 4) against the centers in tiles of BC, D in slabs of 8
  zero-padded columns, a thread's centers (runs of 4, one in each half or
  quarter of the tile) scanned in index order with a strict <, and the
  threads that share a point merged by the lexicographic min of (d², index);
- wide: a CTA a point, 256 threads striding D (by 16-byte vectors where the
  row allows, else by elements), centers in groups of 8, and the CTA's fixed
  tree (a butterfly in each warp, then one over the warps' totals).

Each model is held to ``kmeans_assign_plain`` by PERF.md §2's contract
(equal assignments except within 1e-5 of a tie, dist² within rtol 1e-5
plus 1e-6·max‖p‖², exact on integer points) and, on ``kmeans_dataset``
shapes, to ``repro``'s ``kmeans_assign_blocked`` in interpret mode.  The
regime bounds of ``ops.py`` are held to the ``.cu`` file's.  Keep this file
in step with the kernel.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import kmeans_dataset  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.kmeans_assign import ops  # noqa: E402
from repro_torch.kernels.kmeans_assign.ops import kmeans_assign_plain, regime  # noqa: E402

F32 = np.float32
ROWS_POINTS = 128  # kRowsPoints
SLAB = 8           # kSlab
WIDE_THREADS = 256  # kWideThreads
WIDE_GROUP = 8     # kWideGroup
TILE_CONFIGS = {64: (8, 8, 8), 16: (4, 4, 4)}  # points a CTA: (TY, TM, TN) of the dispatch


def fma(a, b, c):
    """fp32 a·b + c, rounded once (through fp64, which holds a·b exactly)."""
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def d2_of(p2, dot, c2):
    """The kernel's (p2 - 2·dot) + c2 in fp32."""
    return ((p2 - F32(2) * dot).astype(F32) + c2).astype(F32)


def row_of(e: np.ndarray, d: int) -> np.ndarray:
    """load_tile's e / d: the fp32 estimate e·(1/d), truncated, corrected by one."""
    r = (e.astype(F32) * (F32(1) / F32(d))).astype(np.int64)
    r = np.where(r * d > e, r - 1, r)
    return np.where((r + 1) * d <= e, r + 1, r)


def load_tile(flat: np.ndarray, d: int, mis: int, vec: int) -> np.ndarray:
    """The tile as load_tile leaves it: ``flat`` (a tile's elements, its
    pointer ``mis`` elements past a 16-byte boundary) into rows of d | 1
    floats, NaN where nothing was put."""
    total = flat.size
    head = min(total, vec - mis) if mis else 0
    nvec = (total - head) // vec
    tile = np.full((ROWS_POINTS, d | 1), np.nan, F32)
    singles = np.concatenate([np.arange(head), np.arange(head + nvec * vec, total)])
    for starts, cnt in ((singles, 1), (head + vec * np.arange(nvec), vec)):
        r = row_of(starts, d)                 # each put's first row and column,
        c = starts - r * d                    # then one element at a time
        for i in range(cnt):
            tile[r, c] = flat[starts + i]
            c = c + 1
            r, c = np.where(c == d, r + 1, r), np.where(c == d, 0, c)
    return tile


def rows_model(pts: np.ndarray, ctr: np.ndarray, mis: int = 0, vec: int = 4):
    n, d = pts.shape
    k = ctr.shape[0]
    km = 8 if k <= 8 else 16
    sc = np.zeros((km, d), F32)
    sc[:k] = ctr
    c2 = np.zeros(km, F32)
    for j in range(d):
        c2 = fma(sc[:, j], sc[:, j], c2)
    assign, dist = np.zeros(n, np.int32), np.zeros(n, F32)
    for p0 in range(0, n, ROWS_POINTS):
        np_ = min(ROWS_POINTS, n - p0)
        tile = load_tile(pts[p0:p0 + np_].reshape(-1), d, mis, vec)
        assert not np.isnan(tile[:np_, :d]).any()
        rows = tile[:np_, :d]
        p2, dot = np.zeros(np_, F32), np.zeros((np_, km), F32)
        for j in range(d):
            p2 = fma(rows[:, j], rows[:, j], p2)
            dot = fma(rows[:, j, None], sc[None, :, j], dot)
        best, best_d2 = np.zeros(np_, np.int32), np.full(np_, np.inf, F32)
        for c in range(k):
            d2 = d2_of(p2, dot[:, c], c2[c])
            take = (d2 < best_d2) if c else np.ones(np_, bool)
            best, best_d2 = np.where(take, c, best), np.where(take, d2, best_d2)
        assign[p0:p0 + np_], dist[p0:p0 + np_] = best, best_d2
    return assign, dist


def take_min(d2, idx, bd, bi):
    """Lexicographic (d², index), elementwise."""
    take = (d2 < bd) | ((d2 == bd) & (idx < bi))
    return np.where(take, d2, bd), np.where(take, idx, bi)


def tiles_model(pts: np.ndarray, ctr: np.ndarray):
    n, d = pts.shape
    k = ctr.shape[0]
    _, bp = regime(n, d, k)
    ty_n, _, tn = TILE_CONFIGS[bp]
    tx_n = 256 // ty_n
    bc = tn * tx_n
    nslabs = -(-d // SLAB)
    pz = np.zeros((n, nslabs * SLAB), F32)
    pz[:, :d] = pts
    cz = np.zeros((k, nslabs * SLAB), F32)
    cz[:, :d] = ctr
    p2, c2, acc = np.zeros(n, F32), np.zeros(k, F32), np.zeros((n, k), F32)
    for j in range(nslabs * SLAB):           # slabs in order, zero past d
        p2 = fma(pz[:, j], pz[:, j], p2)
        c2 = fma(cz[:, j], cz[:, j], c2)
        acc = fma(pz[:, j, None], cz[None, :, j], acc)
    d2 = d2_of(p2[:, None], acc, c2[None, :])
    big = np.iinfo(np.int32).max
    # each thread column tx: its centers in every center tile (tn / 4 runs
    # of 4, 4·tx_n apart), in index order, by a strict <; centers past K
    # have d² = +inf and are never taken
    per_thread = []
    for tx in range(tx_n):
        bd, bi = np.full(n, np.inf, F32), np.full(n, big, np.int64)
        for c0 in range(0, k, bc):
            for g in range(tn // 4):
                for c in range(4):
                    idx = c0 + g * 4 * tx_n + tx * 4 + c
                    if idx < k:
                        take = d2[:, idx] < bd
                        bd, bi = np.where(take, d2[:, idx], bd), np.where(take, idx, bi)
        per_thread.append((bd, bi))
    bd, bi = per_thread[0]                   # the merge over the thread columns, in order
    for d_x, i_x in per_thread[1:]:
        bd, bi = take_min(d_x, i_x, bd, bi)
    return np.where(bi < k, bi, 0).astype(np.int32), bd


def butterfly(v: np.ndarray) -> np.ndarray:
    """A warp's __shfl_xor_sync sum over its last axis of 32 lanes."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ off]).astype(F32)
    return v


def cta_sums(v: np.ndarray) -> np.ndarray:
    """cta_sums: v (values, threads) → each value's total, by the fixed tree."""
    warps = butterfly(v.reshape(v.shape[0], WIDE_THREADS // 32, 32))[..., 0]
    lanes = np.zeros((v.shape[0], 32), F32)
    lanes[:, :warps.shape[1]] = warps
    return butterfly(lanes)[:, 0]


def wide_model(pts: np.ndarray, ctr: np.ndarray, vec: int):
    """``vec`` elements a step a thread (16-byte loads), or 1 (elements)."""
    n, d = pts.shape
    k = ctr.shape[0]
    steps = -(-d // (vec * WIDE_THREADS))
    pad = steps * vec * WIDE_THREADS
    # thread t's j, in its walk's order: step s, element e of its vector
    js = (np.arange(steps)[:, None, None] * WIDE_THREADS + np.arange(WIDE_THREADS)[None, :, None]) \
        * vec + np.arange(vec)[None, None, :]
    order = js.transpose(0, 2, 1).reshape(-1, WIDE_THREADS)       # (steps·vec, threads)
    assign, dist = np.zeros(n, np.int32), np.zeros(n, F32)
    cz = np.zeros((k, pad), F32)
    cz[:, :d] = ctr
    for p in range(n):
        pz = np.zeros(pad, F32)
        pz[:d] = pts[p]
        best, best_d2, p2 = 0, F32(np.inf), None
        for g0 in range(0, k, WIDE_GROUP):
            kg = min(WIDE_GROUP, k - g0)
            v = np.zeros((1 + 2 * kg, WIDE_THREADS), F32)
            for j in order:                  # each thread's chains, in its order
                x, y = pz[j], cz[g0:g0 + kg, j]
                v[0] = fma(x, x, v[0])
                v[1:1 + kg] = fma(x[None], y, v[1:1 + kg])
                v[1 + kg:] = fma(y, y, v[1 + kg:])
            s = cta_sums(v)
            if g0 == 0:
                p2 = s[0]
            for c in range(kg):
                d2 = d2_of(p2, s[1 + c], s[1 + kg + c])
                if g0 + c == 0 or d2 < best_d2:
                    best, best_d2 = g0 + c, d2
        assign[p], dist[p] = best, best_d2
    return assign, dist


def held(pts, ctr, a, dist, exact=False):
    pa, pd = (t.numpy() for t in kmeans_assign_plain(torch.from_numpy(pts), torch.from_numpy(ctr)))
    if exact:
        assert np.array_equal(a, pa) and np.array_equal(dist, pd)
    diff = a != pa
    if diff.any():                            # only where the two best d² tie within 1e-5
        d2 = ((pts[diff, None, :].astype(np.float64) - ctr[None]) ** 2).sum(-1)
        two = np.sort(d2, axis=1)[:, :2]
        assert ((two[:, 1] - two[:, 0]) <= 1e-5 * np.abs(two[:, 1])).all()
    np.testing.assert_allclose(dist, pd, rtol=1e-5,
                               atol=1e-6 * float((pts.astype(np.float64) ** 2).sum(1).max()))


def repro_held(pts, ctr, a, dist):
    from repro.kernels.kmeans_assign.kernel import kmeans_assign_blocked
    import jax.numpy as jnp

    ja, jd = kmeans_assign_blocked(jnp.asarray(pts), jnp.asarray(ctr), block_n=256,
                                   interpret=True)
    assert np.array_equal(a, np.asarray(ja))
    np.testing.assert_allclose(dist, np.asarray(jd), rtol=1e-5,
                               atol=1e-6 * float((pts.astype(np.float64) ** 2).sum(1).max()))


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(F32)


def test_bounds_in_step_with_the_kernel():
    """ops.py's mirror of the regimes' bounds is the .cu file's."""
    src = (build.CSRC / "kmeans_assign.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kRowsMaxK"), const("kRowsMaxD"), const("kWideMinD"), const("kWideMaxK"),
            const("kTilesFill")) == (ops.ROWS_MAX_K, ops.ROWS_MAX_D, ops.WIDE_MIN_D,
                                     ops.WIDE_MAX_K, ops.TILES_FILL)
    assert (const("kRowsPoints"), const("kSlab"), const("kWideThreads"),
            const("kWideGroup")) == (ROWS_POINTS, SLAB, WIDE_THREADS, WIDE_GROUP)
    for bp, (ty, tm, tn) in TILE_CONFIGS.items():
        assert f"tiles_kernel<T, {ty}, {tm}, {tn}>" in src and tm * ty == bp


@pytest.mark.parametrize("n,d,k,want", [
    (145_253, 54, 7, ("rows", 128)), (10, 54, 16, ("rows", 128)), (10, 54, 17, ("tiles", 16)),
    (10, 64, 7, ("rows", 128)), (10, 65, 7, ("tiles", 16)), (300, 2047, 3, ("tiles", 16)),
    (300, 2048, 3, ("wide", 1)), (300, 60_000, 32, ("wide", 1)),
    (300, 60_000, 33, ("tiles", 16)), (20_000, 64, 1024, ("tiles", 64)),
    (3000, 8, 9000, ("tiles", 16)), (263 * 64, 8, 9000, ("tiles", 16)),
    (263 * 64 + 1, 8, 9000, ("tiles", 64))])
def test_regime_at_the_bounds(n, d, k, want):
    """Each bound ± 1, and the point tile that fills the grid."""
    assert regime(n, d, k) == want


def test_row_of_is_exact():
    """The float estimate of e / d, corrected by one, over every element of
    every tile the rows body takes (d <= 64)."""
    e = np.arange(ROWS_POINTS * ops.ROWS_MAX_D)
    for d in range(1, ops.ROWS_MAX_D + 1):
        sub = e[e < ROWS_POINTS * d]
        assert np.array_equal(row_of(sub, d), sub // d), d


@pytest.mark.parametrize("n,d,vec,mis", [(128, 54, 4, 2), (44, 54, 8, 2), (128, 5, 4, 3),
                                         (7, 13, 8, 7), (1, 1, 4, 1), (128, 64, 4, 0)])
def test_tile_load_puts_every_element_once(n, d, vec, mis):
    """Head, 16-byte vectors and tail put each element of a (ragged) tile at
    its row and column; the padding column stays untouched."""
    flat = np.arange(n * d, dtype=F32)
    tile = load_tile(flat, d, mis, vec)
    assert np.array_equal(tile[:n, :d], flat.reshape(n, d))
    assert np.isnan(tile[:, d:]).all() and np.isnan(tile[n:]).all()


@pytest.mark.parametrize("n,d,k,seed", [(2000, 54, 7, 0), (300, 8, 1, 1), (5, 13, 16, 2),
                                        (129, 64, 9, 3)])
def test_rows_model(n, d, k, seed):
    """Ragged last tile (300, 2000), N below one tile, K = 1, D not a
    multiple of 4, f32 and bf16 vector widths, an unaligned pointer."""
    x, _, _ = kmeans_dataset(n, d, max(k, 2), seed=seed)
    ctr = x[np.random.default_rng(seed).choice(n, k, replace=n < k)]
    for vec, mis in ((4, 0), (4, 2), (8, 6)):
        a, dist = rows_model(x, ctr, mis, vec)
        held(x, ctr, a, dist)
    if n >= 300:
        repro_held(x, ctr, a, dist)


@pytest.mark.parametrize("n,d,k,seed", [(600, 8, 40, 0), (70, 13, 17, 1), (3, 65, 5, 2),
                                        (300, 20, 300, 3)])
def test_tiles_model(n, d, k, seed):
    """Ragged point and center tiles, N below one tile, D not a multiple of
    the slab, K past one center tile (300 > 256)."""
    x, _, _ = kmeans_dataset(n, d, 7, seed=seed)
    ctr = _normal(seed, k, d)
    a, dist = tiles_model(x, ctr)
    held(x, ctr, a, dist)
    if n >= 600:
        repro_held(x, ctr, a, dist)


@pytest.mark.parametrize("n", [300, 264 * 64])
def test_tiles_duplicates_across_splits(n):
    """Duplicate centers on both sides of a thread's run of 4 (3 | 4), of
    its two runs (127 | 128 at 8 x 8) and of a center tile (255 | 256), at
    each point tile: the lower index wins, as in the plain version."""
    ctr = _normal(7, 300, 6, scale=10.0)
    ctr[4], ctr[128], ctr[256] = ctr[3], ctr[127], ctr[255]
    src = np.array([3, 127, 255])[np.arange(n) % 3]
    pts = (ctr[src] + _normal(8, n, 6, scale=0.01)).astype(F32)
    a, dist = tiles_model(pts, ctr)
    pa, _ = kmeans_assign_plain(torch.from_numpy(pts), torch.from_numpy(ctr))
    assert np.array_equal(a, src) and np.array_equal(a, pa.numpy())
    held(pts, ctr, a, dist)


@pytest.mark.parametrize("n,d,k,vec", [(4, 6000, 3, 4), (3, 2050, 1, 1), (2, 4096, 20, 8),
                                       (2, 3001, 9, 1)])
def test_wide_model_integer_points_exact(n, d, k, vec):
    """Integer points at a wide D: every partial sum is exact in fp32, so the
    tree's order gives the plain version's numbers exactly; K = 1, groups of
    8 past K 8, D not a multiple of 4 (element loads)."""
    rng = np.random.default_rng(d)
    pts = rng.integers(-1, 2, size=(n, d)).astype(F32)
    ctr = rng.integers(-1, 2, size=(k, d)).astype(F32)
    ctr[0] = pts[0]
    a, dist = wide_model(pts, ctr, vec)
    held(pts, ctr, a, dist, exact=True)


def test_wide_model_normal_points_and_duplicates():
    """Normal points (the tree's order is not j order: within the contract),
    and a duplicate center across a group boundary (7 | 8): the lower wins."""
    pts = _normal(3, 3, 2500)
    ctr = _normal(4, 12, 2500)
    ctr[8] = ctr[7]
    pts[1] = ctr[7] + _normal(5, 2500, scale=0.01)
    a, dist = wide_model(pts, ctr, 4)
    held(pts, ctr, a, dist)
    assert a[1] == 7
