"""The algorithm of the ssd_scan kernel, emulated on the CPU.

``csrc/ssd_scan.cu`` takes every (batch, head, chunk) as a work item of its
own: the chunk's xbar, B and C zero-padded to its tiles (Q to 16 rows, N
and P to 32 columns), cum by a warp scan in fp64 (inclusive scans of 32,
then the warp sums added in order) kept as two floats, cum + rest, so that
the decays' arguments cum_i - cum_j = (cum_i - cum_j) + (rest_i - rest_j)
keep fp32's precision, the chunk state S_c = (B ∘ exp(cum_{Q-1} -
cum))^T . xbar, then h_c = h_{c-1} exp(cum_{Q-1}) + S_c published into one
of two slots per (batch, head) before y_off = (C ∘ exp(cum)) . h_{c-1} is
formed from the other; the scores C.B^T of 16 rows only on the key tiles up
to their diagonal (16 (m + 1) keys for m-tile m), masked before the exp and
decayed, times xbar, with y_off added to the same sum.  Where the chunk has
8 to 15 m-tiles and P fits one 64-column pass, m-tiles 4-7 take their first
16 (m - 3) - 8 keys as a partial sum added last (another warp computes it).

Every product is 3xTF32: x = big + small, big rounded as ``cvt.rna`` rounds
(``(bits + 0x1000) & 0xffffe000``), small = x - big handed over as it is and
read by the tensor core as its top 19 bits (the low 13 truncated); a.b =
small.big + big.small + big.big in fp32.  The product of two TF32 numbers is
exact in fp32, so an fp32 matmul of TF32 operands gives the tensor core's
products up to the order of its fp32 sums.  These tests hold the emulation
to ``ssd_scan_plain`` and to ``repro``'s ``ssd_scan_bh`` in interpret mode
within 3e-4 (3e-2 in bf16, tests/test_kernels.py:193); one TF32 product, the
control, misses 3e-4.  Nothing here runs the .cu: the kernel itself is held
by the cuda-marked tests of tests/test_torch_lm_kernels.py and
tests/test_torch_inputs.py and by chip_smoke.py.  A change to the kernel's
tiles, split or order of steps must be made here too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ssd_scan.kernel import sub_chunk  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain  # noqa: E402

TOL = dict(rtol=3e-4, atol=3e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as the kernel's to_tf32 does (round to nearest, ties away)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits, as an mma reads a .tf32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_trunc(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32_rna(a) @ tf32_rna(b)


def _pad(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, cols - x.shape[-1], 0, rows - x.shape[-2]))


def warp_scan(a: torch.Tensor) -> torch.Tensor:
    """Inclusive sums along the last axis as the kernel's scan takes them, in
    fp64, a block of 256 at a time: Hillis-Steele within each 32 (lane l
    adds lane l - o for o = 1, 2, .. 16), then the carry and the warp sums
    before it added in order."""
    a = a.double()
    out = torch.empty_like(a)
    carry = torch.zeros(a.shape[:-1], dtype=torch.float64)
    for base in range(0, a.shape[-1], 256):
        blk = a[..., base:base + 256]
        n = blk.shape[-1]
        v = torch.nn.functional.pad(blk, (0, -n % 32)).reshape(*blk.shape[:-1], -1, 32)
        o = 1
        while o < 32:
            v = v + torch.nn.functional.pad(v[..., :-o], (o, 0))
            o <<= 1
        sums = v[..., -1]
        pre = [carry]
        for w in range(sums.shape[-1] - 1):
            pre.append(pre[-1] + sums[..., w])
        out[..., base:base + n] = (torch.stack(pre, -1)[..., None] + v).flatten(-2)[..., :n]
        for w in range(sums.shape[-1]):
            carry = carry + sums[..., w]
    return out


def scan_emulated(xbar, a, B, C, chunk: int, mm=mm_3xtf32, paired: bool = True):
    """y (b, T, H, P) in xbar's dtype by the kernel's algorithm; the chunk is
    walked as the kernel's sub-chunk, one item per (batch, head, chunk), the
    items of a chunk batched over (batch, head)."""
    b, T, H, P = xbar.shape
    G, N = B.shape[2], B.shape[3]
    Q = sub_chunk(chunk, P, N)
    Qp, Np, Pp = -(-Q // 16) * 16, -(-N // 32) * 32, -(-P // 32) * 32
    heads_of = torch.arange(H) // (H // G)
    x32 = xbar.float()
    b32, c32 = B.float()[:, :, heads_of], C.float()[:, :, heads_of]   # (b, T, H, N)
    slots = torch.zeros(b, H, 2, Np, Pp)
    y = torch.empty(b, T, H, P)
    chunks = T // Q
    rows = torch.arange(Qp)
    for c in range(chunks):
        t0 = c * Q
        xs = _pad(x32[:, t0:t0 + Q].transpose(1, 2), Qp, Pp)         # (b, H, Qp, Pp)
        bs = _pad(b32[:, t0:t0 + Q].transpose(1, 2), Qp, Np)
        cs = _pad(c32[:, t0:t0 + Q].transpose(1, 2), Qp, Np)
        av = torch.nn.functional.pad(a[:, t0:t0 + Q].transpose(1, 2).float(), (0, Qp - Q))
        cum64 = warp_scan(av)                                # pads hold cum_{Q-1}
        cum = cum64.float()                                  # kept as cum + rest
        low = (cum64 - cum.double()).float()

        def diff(i, j):
            return (cum[..., i, None] - cum[..., None, j]) + (low[..., i, None] - low[..., None, j])

        last = slice(Q - 1, Q)
        ecum = torch.exp(cum + low)
        sdec = torch.exp(diff(last, slice(None))[..., 0, :])
        # S_c, then h_c published into slot c % 2 before y_off reads slot (c-1) % 2
        S = mm((bs * sdec[..., None]).transpose(-1, -2), xs)          # (b, H, Np, Pp)
        h_prev = slots[:, :, (c - 1) % 2].clone() if c > 0 else None
        if c + 1 < chunks:
            carried = h_prev * torch.exp(cum[..., last] + low[..., last])[..., None] \
                if c > 0 else 0.0
            slots[:, :, c % 2] = carried + S
        acc = torch.zeros(b, H, Qp, Pp)
        mtiles = Qp // 16
        for m in range(mtiles):
            i0, kend = 16 * m, 16 * m + 16
            ci = cs[:, :, i0:kend]
            scores = mm(ci, bs[:, :, :kend].transpose(-1, -2))       # (b, H, 16, kend)
            ri, kj = rows[i0:kend, None], rows[None, :kend]
            arg = diff(slice(i0, kend), slice(0, kend))
            decay = torch.exp(torch.where(ri >= kj, arg, torch.full_like(arg, -float("inf"))))
            s = scores * decay
            pair = paired and Pp <= 64 and 8 <= mtiles < 16 and 4 <= m < 8
            split_keys = 16 * (m - 3) - 8 if pair else 0
            part = mm(s[..., :split_keys], xs[:, :, :split_keys]) if split_keys else 0.0
            rest = mm(s[..., split_keys:], xs[:, :, split_keys:kend])
            if c > 0:
                rest = rest + mm(ci * ecum[..., i0:kend, None], h_prev)
            acc[:, :, i0:kend] = rest + part
        y[:, t0:t0 + Q] = acc[:, :, :Q, :P].transpose(1, 2)
    return y.to(xbar.dtype)


def _inputs(b, T, H, P, G, N, seed=6):
    """tests/test_kernels.py's SSD inputs, as ops.ssd makes xbar and a."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(b, T, H, P)) * 0.5).astype(np.float32))
    dt = torch.from_numpy((np.abs(rng.normal(size=(b, T, H))) * 0.5 + 0.1).astype(np.float32))
    a_log = torch.from_numpy(np.log(np.linspace(1.0, 4.0, H)).astype(np.float32))
    B = torch.from_numpy((rng.normal(size=(b, T, G, N)) * 0.3).astype(np.float32))
    C = torch.from_numpy((rng.normal(size=(b, T, G, N)) * 0.3).astype(np.float32))
    return x * dt[..., None], (dt * -torch.exp(a_log)).float(), B, C


def _repro(xbar, a, B, C, chunk):
    """repro's Pallas kernel in interpret mode on the (BH, T, ·) layout, B/C
    repeated over the heads of a group, back to (b, T, H, P)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.ssd_scan.kernel import ssd_scan_bh

    b, T, H, P = xbar.shape
    G = B.shape[2]
    heads_of = torch.arange(H) // (H // G)

    def bh(t):
        return t.permute(0, 2, 1, *range(3, t.dim())).reshape(b * H, T, *t.shape[3:])

    def j(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())

    out = ssd_scan_bh(j(bh(xbar)), j(bh(a)), j(bh(B[:, :, heads_of])), j(bh(C[:, :, heads_of])),
                      chunk=chunk, interpret=True)
    y = torch.from_numpy(np.array(out.astype(jnp.float32)))
    return y.reshape(b, H, T, P).transpose(1, 2)


# -- the split -----------------------------------------------------------------


def test_split_is_big_rounded_and_small_truncated():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32)) * 10.0
    big, small = split(x)
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    # what the three products see of x: all but ~2^-21 of it
    assert bool(((big + small - x).abs() <= x.abs() * 2.0 ** -21).all())
    assert tf32_rna(torch.tensor([1.0 + 2.0 ** -11])).item() == 1.0 + 2.0 ** -10
    assert tf32_trunc(torch.tensor([1.0 + 3 * 2.0 ** -12])).item() == 1.0


def test_warp_scan_is_a_prefix_sum():
    a = -torch.from_numpy(np.abs(np.random.default_rng(1).normal(size=(3, 300))).astype(
        np.float32))
    np.testing.assert_allclose(warp_scan(a).numpy(), np.cumsum(a.numpy(), -1), rtol=1e-5,
                               atol=1e-5)


# -- the scheme against the plain version and repro --------------------------------


# (b, T, H, P, G, N, chunk): test_kernels.py's shape at chunks 8 / 16 / 32
# (T / Q = 8 at chunk 8), N and P off the tiles with H / G = 2, a chain of
# 16 chunks, mamba2's widths at chunk 128 (the warp pairs of 8 m-tiles)
SHAPES = [(2, 64, 4, 8, 2, 16, 8), (2, 64, 4, 8, 2, 16, 16), (2, 64, 4, 8, 2, 16, 32),
          (2, 64, 4, 20, 2, 12, 16), (1, 128, 2, 7, 1, 13, 8), (1, 256, 2, 64, 1, 128, 128)]


@pytest.mark.parametrize("b,T,H,P,G,N,chunk", SHAPES)
def test_scheme_vs_plain_and_repro_interpret(b, T, H, P, G, N, chunk):
    xbar, a, B, C = _inputs(b, T, H, P, G, N)
    y = scan_emulated(xbar, a, B, C, chunk)
    plain = ssd_scan_plain(xbar, a, B, C, chunk)[0]
    np.testing.assert_allclose(y.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(y.numpy(), _repro(xbar, a, B, C, chunk).numpy(), **TOL)


def test_scheme_pairs_change_only_the_order_of_sums():
    """The warp pairs' partial sums (8 m-tiles, P <= 64) against the same
    scheme with every m-tile summed by one warp: the same y to fp32 noise."""
    xbar, a, B, C = _inputs(1, 256, 2, 64, 1, 128, seed=3)
    paired = scan_emulated(xbar, a, B, C, 128)
    whole = scan_emulated(xbar, a, B, C, 128, paired=False)
    np.testing.assert_allclose(paired.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)


def test_scheme_bf16_vs_repro_interpret():
    """bf16 xbar, B, C widened to fp32 on staging (a fp32); y rounded to bf16."""
    xbar, a, B, C = (t.to(torch.bfloat16) if t.dim() == 4 else t
                     for t in _inputs(2, 64, 4, 20, 2, 12, seed=8))
    y = scan_emulated(xbar, a, B, C, 16)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), _repro(xbar, a, B, C, 16).numpy(), **BF16_TOL)
    np.testing.assert_allclose(y.float().numpy(),
                               ssd_scan_plain(xbar, a, B, C, 16)[0].float().numpy(), **BF16_TOL)


def test_one_tf32_product_misses_the_tolerance():
    """The control: the same scheme with one TF32 product (operands rounded
    once, no small halves) misses 3e-4 at mamba2's widths, where the
    3xTF32 products meet it."""
    xbar, a, B, C = _inputs(1, 256, 2, 64, 1, 128)
    plain = ssd_scan_plain(xbar, a, B, C, 128)[0].numpy()
    np.testing.assert_allclose(scan_emulated(xbar, a, B, C, 128).numpy(), plain, **TOL)
    one = scan_emulated(xbar, a, B, C, 128, mm=mm_1xtf32).numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(one, plain, **TOL)
