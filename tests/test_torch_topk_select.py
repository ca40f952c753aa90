"""topk_compress's bitonic body, its algorithm run on the CPU.

The CUDA body (``csrc/topk_compress.cu`` with ``csrc/radix_select.cuh``)
runs only on a card.  This file carries out the same steps in numpy, with
the kernel's layout — C consecutive lanes a thread, the thread count, the
8-bit digit passes with their early end, the bin search of one warp, the
CTA-wide scan of packed (above, tie) counts, the compaction in position
order, and the bitonic network over next_pow2(k) keys: one key a thread in
registers while they are no more than the threads (the cap), in shared
memory past it — and
holds the result equal to ``topk_compress_plain`` and, at small V, to
``repro``'s ``topk_compress_blocked`` in interpret mode with both bodies,
on inputs made from a seed with numpy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.topk_compress.ops import topk_compress_plain  # noqa: E402

BINS, DIGIT = 256, 8


def layout(block_v: int):
    """(lanes a thread, threads): csrc/topk_compress.cu's lanes_per_thread;
    lanes 0 means 1,024 threads reading ceil(block_v / 1,024) lanes each."""
    for c in (1, 2, 4, 8, 16):
        t = -(-block_v // c)
        if t <= 256 or (c == 16 and t <= 1024):
            return c, -(-t // 32) * 32
    return 0, 1024


def key_hi(x32: np.ndarray, nvalid: int) -> np.ndarray:
    """bits(|x|) + 1 for the lanes below nvalid, 0 past the vector."""
    hi = np.abs(x32).view(np.uint32).astype(np.uint64) + 1
    hi[nvalid:] = 0
    return hi


def find_bin(hist: np.ndarray, need: int):
    """Warp 0's search: lane l sums bins 8l..8l+7, a suffix sum over the
    lanes, then each lane walks its bins from the top."""
    c = hist.reshape(32, BINS // 32)
    mine = c.sum(axis=1)
    suffix = np.cumsum(mine[::-1])[::-1]          # inclusive, over lanes >= l
    found = []
    for lane in range(32):
        above = int(suffix[lane] - mine[lane])
        for i in range(BINS // 32 - 1, -1, -1):
            if above < need <= above + int(c[lane, i]):
                found.append((lane * (BINS // 32) + i, above, int(c[lane, i])))
            above += int(c[lane, i])
    assert len(found) == 1
    return found[0]


def select(hi: np.ndarray, k: int):
    """radix::select: (prefix, mask, need, eq) after at most four passes."""
    prefix = mask = 0
    need, eq = k, 0
    for shift in range(32 - DIGIT, -1, -DIGIT):
        match = (hi & mask) == prefix
        hist = np.bincount(((hi[match] >> shift) & (BINS - 1)).astype(np.int64),
                           minlength=BINS)
        b, above, count = find_bin(hist, need)
        prefix |= b << shift
        mask |= (BINS - 1) << shift
        need -= above
        eq = count
        if eq == need:
            break
    return prefix, mask, need, eq


def bitonic_sort_desc(keys: np.ndarray) -> np.ndarray:
    """bitonic.cuh's network, stage by stage."""
    s = keys.copy()
    n = s.shape[0]
    i = np.arange(n)
    k = 2
    while k <= n:
        j = k >> 1
        while j > 0:
            p = i ^ j
            lo = p > i
            a, b = s[i[lo]], s[p[lo]]
            desc = (i[lo] & k) == 0
            swap = np.where(desc, a < b, a > b)
            s[i[lo][swap]], s[p[lo][swap]] = b[swap], a[swap]
            j >>= 1
        k <<= 1
    return s


def sort_in_registers(keys: np.ndarray, kp: int) -> np.ndarray:
    """topk_compress.cu's sort_in_registers: thread t holds key t (0 past
    k); at each stage it takes its partner t ^ j's key and keeps the larger
    where ((t & run) == 0) == ((t & j) == 0), else the smaller."""
    key = np.zeros(kp, np.uint64)
    key[:keys.shape[0]] = keys
    t = np.arange(kp)
    run = 2
    while run <= kp:
        j = run >> 1
        while j > 0:
            other = key[t ^ j]
            keep_max = ((t & run) == 0) == ((t & j) == 0)
            key = np.where((other > key) == keep_max, other, key)
            j >>= 1
        run <<= 1
    return key


def radix_body(x: np.ndarray, k: int, block_v: int):
    """(idx int32, vals as x's values) of the bitonic body, block by block."""
    v = x.shape[0]
    block_v = min(block_v, v)
    x32 = x.astype(np.float32)
    c, threads = layout(block_v)
    per = c if c else -(-block_v // threads)
    nblocks = -(-v // block_v)
    idx_out = np.zeros(nblocks * k, np.int32)
    val_out = np.zeros(nblocks * k, x.dtype)
    for blk in range(nblocks):
        base = blk * block_v
        nvalid = min(block_v, v - base)
        lane_x = np.zeros(block_v, np.float32)
        lane_x[:nvalid] = x32[base:base + nvalid]
        hi = key_hi(lane_x, nvalid)
        prefix, mask, need, eq = select(hi, k)
        # thread t owns lanes [t * per, t * per + per) of the block
        owner = np.arange(block_v) // per
        gt_lane = (hi & mask) > prefix
        eq_lane = (hi & mask) == prefix
        packed = (np.bincount(owner, weights=gt_lane, minlength=threads).astype(np.uint64)
                  | np.bincount(owner, weights=eq_lane, minlength=threads).astype(
                      np.uint64) << np.uint64(32))
        before = np.concatenate([[0], np.cumsum(packed)[:-1]]).astype(np.uint64)
        assert int(packed.sum() & 0xFFFFFFFF) + min(int(packed.sum() >> 32), need) == k
        kp = 1 << (k - 1).bit_length()
        keys = np.zeros(kp, np.uint64)                # pads (0) sort last
        for t in range(threads):
            g, e = int(before[t] & 0xFFFFFFFF), int(before[t] >> 32)
            for pos in range(t * per, min(t * per + per, block_v)):
                key = (int(hi[pos]) << 32) | (0xFFFFFFFF - pos)
                if gt_lane[pos]:
                    keys[g + min(e, need)] = key
                    g += 1
                elif eq_lane[pos]:
                    if e < need:
                        keys[g + e] = key
                    e += 1
        top = (sort_in_registers(keys[:k], kp) if kp <= threads
               else bitonic_sort_desc(keys))[:k]
        pos = (0xFFFFFFFF - (top & np.uint64(0xFFFFFFFF))).astype(np.int64)
        ok = (top >> np.uint64(32)) != 0
        idx_out[blk * k:(blk + 1) * k] = np.where(ok, base + pos, 0)
        val_out[blk * k:(blk + 1) * k] = np.where(ok, x[np.minimum(base + pos, v - 1)], 0)
    return idx_out, val_out


def _input(kind: str, v: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros(v, np.float32)
    if kind == "ties":      # few distinct magnitudes, both signs
        return rng.choice(np.array([-2.0, -1.0, 1.0, 2.0, 0.5], np.float32), size=v)
    if kind == "signed_zeros":
        x = rng.choice(np.array([0.0, -0.0, 3.0, -3.0], np.float32), size=v,
                       p=[0.45, 0.45, 0.05, 0.05])
        return x.astype(np.float32)
    x = rng.normal(size=v).astype(np.float32)
    x[rng.random(v) >= 0.3] = 0.0
    return x


# (V, block, k): blocks of 32, 100 and 1,024 lanes with a partial last
# block; k = 1, 3, 65, 256 (the cap at block 1,024: 256 threads), cap + 1,
# and k = block; k 1,025 at block 2,048; a block past 16,384 lanes (each
# pass re-reads x)
CASES = [(100, 32, 1), (100, 32, 3), (100, 32, 32), (250, 100, 1), (250, 100, 3),
         (250, 100, 65), (250, 100, 100), (2500, 1024, 1), (2500, 1024, 65),
         (2500, 1024, 256), (2500, 1024, 257), (2500, 1024, 1024), (5000, 2048, 1025),
         (30_000, 20_000, 50)]
KINDS = ["sparse", "zeros", "ties", "signed_zeros"]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("v,block,k", CASES)
def test_radix_body_equals_plain(v, block, k, kind, bf16):
    x = _input(kind, v, seed=v + k)
    t = torch.from_numpy(x)
    if bf16:
        t = t.to(torch.bfloat16)
    xv = t.float().numpy() if bf16 else x
    idx, vals = radix_body(xv, k, block)
    pi, pv = topk_compress_plain(t, k, block)
    assert np.array_equal(idx, pi.numpy())
    # the values bit for bit (-0.0 kept): compare the float32 bits
    assert np.array_equal(vals.astype(np.float32).view(np.uint32),
                          pv.float().numpy().view(np.uint32))


# small V, so that interpret mode stays within a few seconds
REPRO_CASES = [(100, 32, 3, kind) for kind in KINDS] + [(250, 100, 65, "sparse")]


@pytest.mark.parametrize("method", ["argmax", "bitonic"])
@pytest.mark.parametrize("v,block,k,kind", REPRO_CASES)
def test_radix_body_equals_repro_interpret(v, block, k, kind, method):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.topk_compress.kernel import topk_compress_blocked

    x = _input(kind, v, seed=v + k)
    idx, vals = radix_body(x, k, block)
    ij, vj = topk_compress_blocked(jnp.asarray(x), k_per_block=k, block_v=block,
                                   interpret=True, method=method)
    assert np.array_equal(idx, np.asarray(ij))
    assert np.array_equal(vals.view(np.uint32), np.asarray(vj).view(np.uint32))


def test_early_end_and_ties():
    """The passes end at the first digit whose bin is taken whole (all
    zeros, k = block: one pass); else they run to the last digit, and the
    ties at the cut go to the lower positions."""
    hi = key_hi(np.zeros(64, np.float32), 64)
    assert select(hi, 64) == (0, 0xFF000000, 64, 64)
    assert select(hi, 10) == (1, 0xFFFFFFFF, 10, 64)
    hi = key_hi(np.array([1.0] * 6 + [2.0] * 2, np.float32), 8)
    prefix, mask, need, eq = select(hi, 4)
    assert mask == 0xFFFFFFFF and eq == 6 and need == 2
    x = np.array([1.0, -2.0, 1.0, 1.0, 2.0, 1.0], np.float32)
    idx, vals = radix_body(x, 4, 6)
    assert idx.tolist() == [1, 4, 0, 2] and vals.tolist() == [-2.0, 2.0, 1.0, 1.0]


def test_layout():
    """256 threads of 4 lanes at block 1,024; 1,024 threads of 16 lanes at
    16,384; past that 1,024 threads re-reading x."""
    assert layout(1024) == (4, 256) and layout(100) == (1, 128) and layout(7) == (1, 32)
    assert layout(2048) == (8, 256) and layout(16_384) == (16, 1024)
    assert layout(16_385) == (0, 1024) and layout(65_536) == (0, 1024)
