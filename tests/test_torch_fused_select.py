"""fused_topk_scatter's CUDA kernel, its algorithm run on the CPU.

The kernel (``csrc/fused_scatter.cu`` with ``csrc/radix_select.cuh``) runs
only on a card.  This file carries out the same steps in numpy, with the
kernel's layout — C consecutive lanes a thread (``lanes_per_thread``),
rows in groups of ``GROUP`` whose 8-bit digit passes run together, each
row closed at its first digit whose bin is taken whole, the ties at a cut
given to the lowest positions through a CTA scan of each thread's tie
count, and the fold of each thread's lanes in row order, 16 lanes at a time
past 8 a thread (the cuts reused from tile to tile while the rows make one
group, selected again for each tile otherwise), starting from ``acc =
c_0`` — and holds the result bit-equal to ``fused_topk_scatter_plain``
and, at small V, to ``repro``'s ``fused_topk_scatter`` in interpret mode,
on inputs made from a seed with numpy.  Keep ``layout``, ``GROUP`` and
``TILE`` in step with the kernel.
"""

import numpy as np
import pytest
from radix_select_model import key_hi, select_rows

torch = pytest.importorskip("torch")

from repro_torch.core.sparse import block_layout  # noqa: E402
from repro_torch.kernels.accumulate.fused_scatter import fused_topk_scatter_plain  # noqa: E402

GROUP = 4          # kRowGroup: rows whose selects run together
TILE = 16          # kTile: lanes a thread folds at a time past 8 lanes a thread
LOW = np.uint64(0xFFFFFFFF)


def layout(block_eff: int):
    """(C, threads, lanes a thread): fused_scatter.cu's lanes_per_thread and
    lpt; C 0 means 512 threads of ceil(block_eff / 512) lanes rounded up to
    a multiple of 8, read from x."""
    for c in (1, 2, 4, 8):
        t = -(-block_eff // c)
        if t <= 256:
            return c, -(-t // 32) * 32, c
    return 0, 512, (-(-block_eff // 512) + 7) // 8 * 8


def thresholds(hi: np.ndarray, k: int, per: int, threads: int) -> list:
    """Each row's threshold key: (prefix, 0) for a cut taken whole, else the
    key of the need-th tied lane by position, found as the kernel finds it:
    each thread's tie count, their exclusive scan, and a walk of the lanes
    of the thread whose range holds the need-th."""
    cuts, _ = select_rows(hi, k)
    owner = np.arange(hi.shape[1]) // per
    thr = []
    for r, (prefix, mask, need, eq) in enumerate(cuts):
        if eq == need:
            thr.append(prefix << 32)
            continue
        assert mask == 0xFFFFFFFF and eq > need
        tied = hi[r] == np.uint64(prefix)
        counts = np.bincount(owner[tied], minlength=threads)
        before = np.concatenate([[0], np.cumsum(counts)[:-1]])
        t = int(np.nonzero((before < need) & (need <= before + counts))[0][0])
        e = int(before[t])
        for pos in range(t * per, min(t * per + per, hi.shape[1])):
            if tied[pos]:
                e += 1
                if e == need:
                    thr.append(prefix << 32 | (0xFFFFFFFF - pos))
                    break
    return thr


def fused_kernel(x32: np.ndarray, per_block: int, block_eff: int) -> np.ndarray:
    """The kernel on x32 (N, V) float32 values: out (V,) in fp32, before
    the cast to x's dtype."""
    n, v = x32.shape
    block_eff = min(block_eff, v)
    c, threads, per = layout(block_eff)
    lanes = c if c else TILE
    ntiles = 1 if c else -(-per // TILE)
    group = GROUP
    select_all = per_block >= block_eff
    known = {}                  # the cuts of each group, once the first tile found them
    pos = np.arange(block_eff)
    lane_of_thread = pos - (pos // per) * per
    out = np.zeros(v, np.float32)
    for base in range(0, v, block_eff):
        nvalid = min(block_eff, v - base)
        vals = np.zeros((n, block_eff), np.float32)
        vals[:, :nvalid] = x32[:, base:base + nvalid]
        hi = key_hi(vals, nvalid)
        keys = hi << np.uint64(32) | (LOW - pos.astype(np.uint64))
        acc = np.zeros(block_eff, np.float32)
        for tile in range(ntiles):
            # the lanes this tile folds: lanes tile*L .. tile*L + L - 1 of each thread's
            mine = (lane_of_thread >= tile * lanes) & (lane_of_thread < tile * lanes + lanes)
            for r0 in range(0, n, group):
                g = min(group, n - r0)
                if select_all:
                    thr = [0] * g
                elif tile > 0 and n <= group:
                    thr = known[r0]     # one group: its cuts stay in shared memory
                else:
                    thr = known[r0] = thresholds(hi[r0:r0 + g], per_block, per, threads)
                for r in range(g):
                    kept = np.where(keys[r0 + r] >= np.uint64(thr[r]), vals[r0 + r],
                                    np.float32(0.0))
                    acc[mine] = kept[mine] if r0 + r == 0 else acc[mine] + kept[mine]
        out[base:base + nvalid] = acc[:nvalid]
    return out


def _input(rng, n: int, v: int, density: float, signed_zeros: bool = False) -> np.ndarray:
    x = rng.normal(size=(n, v)).astype(np.float32)
    zero = np.float32(-0.0) if signed_zeros else np.float32(0.0)
    x[rng.random((n, v)) >= density] = zero
    return x


def _check(x: np.ndarray, per_block: int, block_eff: int, bf16: bool = False) -> np.ndarray:
    """The model bit-equal to the plain version (float32 bits compared, so
    that -0.0 and +0.0 differ); returns the model's result in x's dtype."""
    t = torch.from_numpy(x)
    if bf16:
        t = t.to(torch.bfloat16)
    got = torch.from_numpy(fused_kernel(t.float().numpy(), per_block, block_eff)).to(t.dtype)
    ref = fused_topk_scatter_plain(t, per_block, block_eff)
    assert got.dtype == ref.dtype
    assert np.array_equal(got.float().numpy().view(np.uint32), ref.float().numpy().view(np.uint32))
    return got.float().numpy()


# test_kernels.py's five shapes (n, v, k, block)
SHAPES = [(4, 16384, 512, 1024), (8, 1000, 50, 256), (1, 100, 10, 1024), (3, 900, 900, 256),
          (2, 7, 3, 1024)]


@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
@pytest.mark.parametrize("n,v,k,block", SHAPES)
def test_kernel_algorithm_equals_plain(n, v, k, block, density):
    x = _input(np.random.default_rng(v + k), n, v, density)
    _, be, pb = block_layout(v, k, block)
    _check(x, pb, be)


@pytest.mark.parametrize("n,v,k,block", SHAPES[:3])
def test_kernel_algorithm_bf16(n, v, k, block):
    """bf16 selects on the fp32 magnitude of the bf16 value and rounds the
    fp32 fold once."""
    x = _input(np.random.default_rng(n), n, v, 0.3)
    _, be, pb = block_layout(v, k, block)
    _check(x, pb, be, bf16=True)


# blocks of 2,048 (8 lanes a thread), 16,384 (512 threads of 32 lanes read
# from x, folded in 2 tiles) and 65,536 (128 lanes, 8 tiles), at small N,
# and at 17 rows (five groups: each tile selects again); (n, v, k, block)
BIG = [(2, 5000, 700, 2048), (3, 20_000, 1500, 16_384), (2, 70_000, 9000, 65_536),
       (3, 70_000, 70_000, 65_536), (17, 20_000, 1500, 16_384)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,v,k,block", BIG)
def test_kernel_algorithm_big_blocks(n, v, k, block, bf16):
    x = _input(np.random.default_rng(block), n, v, 0.3)
    _, be, pb = block_layout(v, k, block)
    _check(x, pb, be, bf16=bf16)


def test_one_row_keeps_negative_zero():
    """N = 1: acc = c_0, so a kept -0.0 stays -0.0 (0.0 + -0.0 would be
    +0.0), and a dropped lane is +0.0, as in repro."""
    x = _input(np.random.default_rng(3), 1, 3000, 0.2, signed_zeros=True)
    _, be, pb = block_layout(3000, 1200, 1024)
    out = _check(x, pb, be)
    assert np.signbit(out[out == 0]).any() and not np.signbit(out[out == 0]).all()


@pytest.mark.parametrize("n", [5, 17, 40])
def test_rows_past_one_group(n):
    """More rows than a group holds (5 and 17 rows end in a group of one),
    the fold carried in registers from group to group."""
    x = _input(np.random.default_rng(n), n, 3000, 0.1)
    _, be, pb = block_layout(3000, 700, 1024)
    assert n > GROUP
    _check(x, pb, be)


@pytest.mark.parametrize("n,v,block,per_block", [(3, 1000, 256, 256), (2, 1000, 256, 300),
                                                 (4, 500, 128, 128)])
def test_select_all(n, v, block, per_block):
    """per_block >= block_eff keeps every valid lane (no select)."""
    x = _input(np.random.default_rng(v), n, v, 0.5)
    _check(x, per_block, block)


@pytest.mark.parametrize("n,v,k,block", [(4, 700, 60, 1024), (2, 20_000, 500, 65_536)])
def test_vector_shorter_than_block(n, v, k, block):
    x = _input(np.random.default_rng(v), n, v, 0.4)
    _, be, pb = block_layout(v, k, block)
    assert be == v
    _check(x, pb, be)


def test_last_block_quota_past_its_lanes():
    """A last block with fewer valid lanes than per_block: the cut lands on
    the lanes past the vector (hi 0), and every valid lane is kept."""
    x = _input(np.random.default_rng(1), 3, 1000, 1.0)
    _check(x, 240, 256)        # the last block holds 232 valid lanes


# small V, so that interpret mode stays within a few seconds; (n, v, k, block, density)
REPRO_CASES = [(4, 2000, 400, 512, 0.3), (8, 1000, 50, 256, 0.01), (1, 100, 10, 1024, 0.0),
               (3, 900, 900, 256, 1.0), (2, 7, 3, 1024, 0.5), (6, 600, 200, 128, 0.3)]


@pytest.mark.parametrize("n,v,k,block,density", REPRO_CASES)
def test_kernel_algorithm_equals_repro_interpret(n, v, k, block, density):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.accumulate.fused_scatter import fused_topk_scatter

    x = _input(np.random.default_rng(n * v), n, v, density)
    _, be, pb = block_layout(v, k, block)
    got = _check(x, pb, be)
    ref = fused_topk_scatter(jnp.asarray(x), per_block=pb, block_eff=be, interpret=True)
    assert np.array_equal(got.view(np.uint32), np.asarray(ref).view(np.uint32))


def test_early_end_and_ties():
    """A group's rows close at their own passes: an all-zero row at the
    first digit when its quota takes the block, else after four; a row
    of distinct magnitudes once its bin holds exactly the lanes needed.
    Ties at a cut go to the lower positions."""
    hi = key_hi(np.zeros((2, 64), np.float32), 64)
    hi[1] = key_hi(np.arange(1, 65, dtype=np.float32), 64)
    cuts, passes = select_rows(hi, 64)
    assert cuts[0] == (0, 0xFF000000, 64, 64) and passes == 1
    cuts, passes = select_rows(hi, 10)
    assert cuts[0] == (1, 0xFFFFFFFF, 10, 64) and passes == 4
    assert cuts[1][2] == cuts[1][3]
    x = np.array([[1.0, -2.0, 1.0, 1.0, 2.0, 1.0]], np.float32)
    assert fused_kernel(x, 4, 6).tolist() == [1.0, -2.0, 1.0, 0.0, 2.0, 0.0]


def test_layout():
    """256 threads of 4 lanes at block 1,024 (pagerank) and of 2 at 512
    (logreg), of 8 at 2,048; past that 512 threads reading x."""
    assert layout(1024) == (4, 256, 4) and layout(512) == (2, 256, 2)
    assert layout(7) == (1, 32, 1) and layout(2048) == (8, 256, 8)
    assert layout(2049) == (0, 512, 8) and layout(16_384) == (0, 512, 32)
    assert layout(40_000) == (0, 512, 80) and layout(65_536) == (0, 512, 128)
