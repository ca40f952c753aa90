"""radix_select.cuh's select, in numpy: the model that the CPU tests of
topk_compress's bitonic body (``test_torch_topk_select.py``) and of
fused_topk_scatter's kernel (``test_torch_fused_select.py``) share, as the
two kernels share ``radix::select_rows``.  Keep it in step with the header.
"""

import numpy as np

BINS, DIGIT = 256, 8


def key_hi(x32: np.ndarray, nvalid: int) -> np.ndarray:
    """bits(|x|) + 1 for the lanes below nvalid, 0 past the vector (lanes on
    the last axis)."""
    hi = np.abs(x32).view(np.uint32).astype(np.uint64) + 1
    hi[..., nvalid:] = 0
    return hi


def find_bin(hist: np.ndarray, need: int):
    """radix::find_bin, one warp's search: lane l sums bins 8l..8l+7, a
    suffix sum over the lanes, then each lane walks its bins from the top."""
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


def select_rows(hi: np.ndarray, k: int):
    """radix::select_rows over a group's rows hi (g, lanes): the rows'
    passes run together, a row skipped once its bin is taken whole; each
    row's (prefix, mask, need, eq), and the passes the group ran."""
    cuts = [[0, 0, k, 0] for _ in range(hi.shape[0])]
    passes = 0
    for shift in range(32 - DIGIT, -1, -DIGIT):
        passes += 1
        for r, cut in enumerate(cuts):
            prefix, mask, need, eq = cut
            if eq == need:
                continue
            match = (hi[r] & np.uint64(mask)) == np.uint64(prefix)
            hist = np.bincount(((hi[r][match] >> np.uint64(shift)) & np.uint64(BINS - 1))
                               .astype(np.int64), minlength=BINS)
            b, above, count = find_bin(hist, need)
            cuts[r] = [prefix | b << shift, mask | (BINS - 1) << shift, need - above, count]
        if all(eq == need for _, _, need, eq in cuts):
            break
    return [tuple(c) for c in cuts], passes
