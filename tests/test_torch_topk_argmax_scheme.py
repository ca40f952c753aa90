"""topk_compress's argmax body, its algorithm run on the CPU.

The CUDA body (``topk_list_kernel`` in ``csrc/topk_compress.cu``) runs only
on a card.  This file carries out the same steps in numpy, with the
kernel's layout: the CTA's threads (4, 8 or 16 lanes a thread, 1,024
threads past 16,384 lanes) and the block in groups of 4 lanes a thread;
each warp's top kp = next_pow2(k) keys of its first group by its bitonic
network (runs of kp sorted in alternating directions, pairs of runs folded
and cleaned); a later group's keys filtered by the warp list's k-th key
before they enter — none: skipped; at most 32: compacted one a lane,
sorted as 32 and merged in; more: the group's network, merged in; the
warps' lists merged pairwise in shared memory, a level a barrier; a k past
the list cap taken in segments, each bounded by the last key of the one
before.  It holds the result equal to ``topk_compress_plain`` and, at small
V, to ``repro``'s ``topk_compress_blocked(method="argmax")`` in interpret
mode, on inputs made from a seed with numpy.  Keep it in step with the
kernel.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.topk_compress import ops  # noqa: E402
from repro_torch.kernels.topk_compress.ops import topk_compress_plain  # noqa: E402

LIST_CAP = 256  # kListCap: keys a warp's list holds at most
GROUP = 4       # kGroup: lanes a thread loads and sorts at a time
FILL_CTAS = 132  # kFillCtas: past this many CTAs the layout is for the work
WIDE_LANES = 32  # kWideLanes: lanes a thread past FILL_CTAS CTAs
TOP = np.uint64(2 ** 64 - 1)


def layout(block_v: int, nblocks: int = 1):
    """(threads, groups): csrc/topk_compress.cu's argmax_layout."""
    threads = 1024
    if nblocks > FILL_CTAS:
        threads = min(1024, -(-(-(-block_v // WIDE_LANES)) // 32) * 32)
    else:
        for c in (4, 8, 16):
            t = -(-block_v // c)
            if t <= 1024:
                threads = -(-t // 32) * 32
                break
    return threads, -(-block_v // (threads * GROUP))


def next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def stage(key: np.ndarray, j: int, dirmask: int) -> np.ndarray:
    """One compare-exchange stage: e against e ^ j, the pair descending
    where (e & dirmask) == 0, else ascending (dirmask 0: descending)."""
    e = np.arange(key.shape[0])
    other = key[e ^ j]
    keep_max = ((e & dirmask) == 0) == ((e & j) == 0)
    return np.where((other > key) == keep_max, other, key)


def warp_top(key: np.ndarray, kp: int) -> np.ndarray:
    """warp_top over a warp's keys in e order: the top R = min(kp, keys),
    descending."""
    s = key.shape[0]
    r = min(kp, s)
    run = 2
    while run <= r:                     # runs of R, alternating directions
        j = run >> 1
        while j:
            key = stage(key, j, run)
            j >>= 1
        run <<= 1
    e = np.arange(s)
    half = r
    while half < s:                     # fold pairs of runs, then clean
        key = np.where(e & half, key, np.maximum(key, key[e ^ half]))
        j = r >> 1
        while j:
            key = stage(key, j, half << 1)
            j >>= 1
        half <<= 1
    top = key[:r]
    assert np.all((top[:-1] > top[1:]) | (top[1:] == 0))  # key 0: lanes past the block
    return top


def merge_lists(mine: np.ndarray, other: np.ndarray, n_other: int) -> np.ndarray:
    """merge_lists: e keeps max(mine[e], other[kp - 1 - e]) (0 past
    other's n_other keys), then a clean."""
    kp = mine.shape[0]
    e = np.arange(kp)
    padded = np.zeros(kp, np.uint64)
    m = min(n_other, kp)
    padded[:m] = other[:m]
    key = np.maximum(mine, np.where(kp - 1 - e < n_other, padded[kp - 1 - e], 0))
    j = kp >> 1
    while j:
        key = stage(key, j, 0)
        j >>= 1
    return key


def lane_keys(x32: np.ndarray, base: int, nvalid: int, block_v: int, lanes: int):
    """load_keys for positions 0..lanes of a block: bitonic.cuh's packed
    key, hi 0 past the vector, key 0 past the block."""
    pos = np.arange(lanes)
    mag = np.zeros(lanes, np.float32)
    mag[:nvalid] = np.abs(x32[base:base + nvalid])
    hi = np.where(pos < nvalid, mag.view(np.uint32).astype(np.uint64) + 1, 0)
    key = (hi << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - pos.astype(np.uint64))
    return np.where(pos < block_v, key, np.uint64(0))


def list_body(x: np.ndarray, k: int, block_v: int, stats: dict | None = None):
    """(idx int32, vals as x's values) of the argmax body, block by block."""
    v = x.shape[0]
    block_v = min(block_v, v)
    x32 = x.astype(np.float32)
    nblocks = -(-v // block_v)
    threads, groups = layout(block_v, nblocks)
    nwarps, span, s = threads // 32, threads * GROUP, 32 * GROUP
    idx_out = np.zeros(nblocks * k, np.int32)
    val_out = np.zeros(nblocks * k, x.dtype)
    stats = {} if stats is None else stats
    for name in ("skipped", "few", "networked", "barriers", "segments"):
        stats.setdefault(name, 0)
    for blk in range(nblocks):
        base = blk * block_v
        keys = lane_keys(x32, base, min(block_v, v - base), block_v, groups * span)
        bound = TOP
        for done in range(0, k, LIST_CAP):
            n = min(k - done, LIST_CAP)
            kp = next_pow2(n)
            stats["segments"] += 1
            lists = np.zeros((nwarps, kp), np.uint64)
            for w in range(nwarps):        # thread 32 w + lane: lanes g span + w s + lane 4 + r
                theta = np.uint64(0)
                for g in range(groups):
                    key = keys[g * span + w * s:g * span + (w + 1) * s]
                    key = np.where((key < bound) & (key > theta), key, np.uint64(0))
                    count = int(np.count_nonzero(key))
                    if g > 0 and count == 0:
                        stats["skipped"] += 1
                        continue
                    if g > 0 and count <= 32:        # one a lane, sorted as 32
                        one = np.zeros(32, np.uint64)
                        one[:count] = key[key != 0]
                        lists[w] = merge_lists(lists[w], warp_top(one, 32), 32)
                        stats["few"] += 1
                    else:
                        top = warp_top(key, kp)
                        if g == 0:
                            lists[w] = np.concatenate([top, np.zeros(kp - top.shape[0],
                                                                     np.uint64)])
                        else:
                            lists[w] = merge_lists(lists[w], top, top.shape[0])
                            stats["networked"] += 1
                    theta = lists[w][n - 1]
            stats["barriers"] += 1
            step = 1
            while step < nwarps:               # pairwise, a barrier a level
                for w in range(0, nwarps, 2 * step):
                    if w + step < nwarps:
                        lists[w] = merge_lists(lists[w], lists[w + step], kp)
                stats["barriers"] += 1
                step <<= 1
            top = lists[0][:n]
            assert np.all(top[:-1] > top[1:]) and top[-1] < bound
            pos = (np.uint64(0xFFFFFFFF) - (top & np.uint64(0xFFFFFFFF))).astype(np.int64)
            ok = (top >> np.uint64(32)) != 0
            slots = slice(blk * k + done, blk * k + done + n)
            idx_out[slots] = np.where(ok, base + pos, 0)
            val_out[slots] = np.where(ok, x[np.minimum(base + pos, v - 1)], 0)
            bound = top[-1]
            if done + n < k:
                stats["barriers"] += 1
    return idx_out, val_out


def _input(kind: str, v: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros(v, np.float32)
    if kind == "ties":      # few distinct magnitudes, both signs
        return rng.choice(np.array([-2.0, -1.0, 1.0, 2.0, 0.5], np.float32), size=v)
    if kind == "signed_zeros":
        return rng.choice(np.array([0.0, -0.0, 3.0, -3.0], np.float32), size=v,
                          p=[0.45, 0.45, 0.05, 0.05]).astype(np.float32)
    x = rng.normal(size=v).astype(np.float32)
    x[rng.random(v) >= 0.3] = 0.0
    return x


# (V, block, k): logreg's one block of 512 (k 32) and k = 1 and block;
# blocks of 32, 100 (one warp) and 1,024 (8 warps) with a partial last
# block; k 129 at block 1,024 (kp 256 past a warp's 128 keys), the cap 256,
# one past it and 600 (segments of 256); blocks of 2,048 (16 warps) and
# 5,000 (20 warps of two groups: a tree of 5 levels over a warp count that
# is no power of two); 16,384 (32 warps of four groups) and 20,000 (five
# groups, 1,024 threads past 16,384 lanes), k 24 and 300; 134 blocks of 512
# (past 132 CTAs: one warp of four groups)
CASES = [(512, 512, 32), (512, 512, 1), (512, 512, 512), (100, 32, 3), (100, 32, 32),
         (250, 100, 65), (2500, 1024, 1), (2500, 1024, 33), (2500, 1024, 129),
         (2500, 1024, 256), (2500, 1024, 257), (2500, 1024, 600), (5000, 2048, 300),
         (9000, 5000, 40), (20_000, 16_384, 24), (20_000, 20_000, 24), (40_000, 20_000, 300),
         (68_196, 512, 24), (68_196, 512, 300)]
KINDS = ["sparse", "zeros", "ties", "signed_zeros"]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("v,block,k", CASES)
def test_list_body_equals_plain(v, block, k, kind, bf16):
    x = _input(kind, v, seed=v + k)
    t = torch.from_numpy(x)
    if bf16:
        t = t.to(torch.bfloat16)
    xv = t.float().numpy() if bf16 else x
    idx, vals = list_body(xv, k, block)
    pi, pv = topk_compress_plain(t, k, block)
    assert np.array_equal(idx, pi.numpy())
    # the values bit for bit (-0.0 kept): compare the float32 bits
    assert np.array_equal(vals.astype(np.float32).view(np.uint32),
                          pv.float().numpy().view(np.uint32))


# small V, so that interpret mode stays within a few seconds
REPRO_CASES = [(100, 32, 3, kind) for kind in KINDS] + [(250, 100, 65, "sparse"),
                                                        (512, 512, 32, "sparse")]


@pytest.mark.parametrize("v,block,k,kind", REPRO_CASES)
def test_list_body_equals_repro_interpret(v, block, k, kind):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.topk_compress.kernel import topk_compress_blocked

    x = _input(kind, v, seed=v + k)
    idx, vals = list_body(x, k, block)
    ij, vj = topk_compress_blocked(jnp.asarray(x), k_per_block=k, block_v=block,
                                   interpret=True, method="argmax")
    assert np.array_equal(idx, np.asarray(ij))
    assert np.array_equal(vals.view(np.uint32), np.asarray(vj).view(np.uint32))


def test_threshold_filter_and_barriers():
    """A later group enters only as far as its keys pass the warp list's
    k-th key: a block whose largest entries all lie in its first group
    skips every later group, and on sparse normal data most later groups
    go the few-keys way.  The barriers are one after the lists and one a
    level of their pairwise merges a segment, plus one between segments: 3
    at logreg's shape, where the old body paid 2 a round (64)."""
    x = np.zeros(40_000, np.float32)
    x[:2000] = np.random.default_rng(1).normal(size=2000).astype(np.float32) + 10.0
    stats = {}
    idx, _ = list_body(x, 24, 40_000, stats)
    assert layout(40_000) == (1024, 10) and stats["skipped"] == 9 * 32
    assert stats["few"] == stats["networked"] == 0
    assert np.array_equal(idx, topk_compress_plain(torch.from_numpy(x), 24, 40_000)[0].numpy())
    stats = {}
    list_body(_input("sparse", 65_536, 2), 24, 65_536, stats)
    assert stats["few"] > 2 * stats["networked"] > 0
    stats = {}
    list_body(_input("sparse", 512, 3), 32, 512, stats)
    assert stats == {"skipped": 0, "few": 0, "networked": 0, "barriers": 3, "segments": 1}
    stats = {}
    list_body(_input("sparse", 2500, 4), 600, 1024, stats)
    assert stats["segments"] == 3 * 3 and stats["barriers"] == 3 * (3 * 4 + 2)


def test_layout():
    """Up to 132 CTAs: 4 lanes a thread to block 4,096 (logreg's 512: 4
    warps), 8 to 8,192, 16 to 16,384 (1,024 threads); past that 1,024
    threads; groups of 4 lanes a thread over the block.  The constants and the shared memory
    bound are the kernel's."""
    assert layout(512) == (128, 1) and layout(1024) == (256, 1)
    assert layout(7) == (32, 1) and layout(100) == (32, 1)
    assert layout(2048) == (512, 1) and layout(4096) == (1024, 1)
    assert layout(5000) == (640, 2) and layout(8192) == (1024, 2)
    assert layout(16_384) == (1024, 4)
    assert layout(16_385) == (1024, 5) and layout(65_536) == (1024, 16)
    # past 132 CTAs, 32 lanes a thread: pagerank's 1,024-lane blocks one warp
    assert layout(1024, 133) == (32, 8) and layout(1024, 132) == (256, 1)
    assert layout(512, 4734) == (32, 4) and layout(65_536, 200) == (1024, 16)
    src = (build.CSRC / "topk_compress.cu").read_text()
    assert re.search(r"constexpr int kListCap = (\d+);", src).group(1) == str(LIST_CAP)
    assert re.search(r"constexpr int kGroup = (\d+);", src).group(1) == str(GROUP)
    assert re.search(r"constexpr long long kFillCtas = (\d+);", src).group(1) == str(FILL_CTAS)
    assert re.search(r"constexpr int kWideLanes = (\d+);", src).group(1) == str(WIDE_LANES)
    assert ops.LIST_CAP == LIST_CAP
    # 32 warps' lists at the cap and their staging keys fit a CTA's shared
    # memory: no scratch
    assert 32 * (LIST_CAP + 32 * GROUP) * 8 <= build.MAX_SHARED_BYTES
    assert ops.work_bytes(65_536, 20_000, "argmax") == 0
