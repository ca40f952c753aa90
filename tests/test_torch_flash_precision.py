"""The precision scheme of the fp32 flash attention kernel, emulated on the CPU.

``csrc/flash_attention.cu`` computes both products of its float32 body on
the tensor cores in 3xTF32: each operand x = big + small, big = tf32(x) and
small = tf32(x - big), rounded as ``cvt.rna.tf32.f32`` rounds (to nearest,
ties away from zero, 10 mantissa bits), and a.b = small.big + big.small +
big.big, summed in fp32.  The product of two TF32 numbers is exact in fp32
(11 + 11 significant bits), so an fp32 matmul of TF32 operands gives the
tensor core's products up to the order of its fp32 sums.  These tests hold
attention built on the emulated product to the kernel's tolerance (3e-5,
``tests/test_kernels.py:13``) against the plain version; one TF32 product,
the control, misses it.  No GPU is needed.

These cases check the scheme, not the kernel: nothing here runs the .cu.
``tf32_rna`` is the kernel's ``to_tf32`` expression, ``(bits + 0x1000) &
0xffffe000`` on the fp32 bits; a change to that expression must be made
here too.  The kernel itself is held to 3e-5 by the cuda-marked tests of
``tests/test_torch_lm_kernels.py`` and by ``chip_smoke.py``.

The bfloat16 body (wgmma) is emulated the same way: its scores are the fp32
products of bf16 q and k (exact on the tensor cores), summed in fp32; per
KV tile of 128 keys the online softmax runs in log2 units (m from -1e30, p =
exp2(s * scale * log2(e) - m), l summing the fp32 p), and P is rounded to
bf16, to nearest even as ``cvt.rn.bf16x2.f32`` rounds, before O += P.V in
fp32.  That attention is held against ``repro``'s Pallas kernel in
interpret mode on the same bf16 inputs, to the bf16 limit of 3e-2.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention.kernel import gqa_plain  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_bhsd_ref  # noqa: E402

TOL = dict(rtol=3e-5, atol=3e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)   # tests/test_kernels.py:13, bf16
LOG2E = 1.4426950408889634


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as cvt.rna does: round the magnitude to 10 mantissa bits,
    ties away from zero (add half an ulp to the bits, clear the low 13)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel computes it: small.big + big.small + big.big."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32_rna(a) @ tf32_rna(b)


def attention_emulated(q, k, v, *, causal: bool, q_offset: int = 0, mm=mm_3xtf32):
    """q (BH, T, dk), k (BH, S, dk), v (BH, S, dv): the kernel's arithmetic,
    with its zero padding (dk to a multiple of 32, dv to one of 32) and its
    products emulated by ``mm``; the online softmax folded into one pass."""
    dk, dv = q.shape[-1], v.shape[-1]
    pad_k, pad_v = -dk % 32, -dv % 32
    qp, kp = (torch.nn.functional.pad(x, (0, pad_k)) for x in (q, k))
    vp = torch.nn.functional.pad(v, (0, pad_v))
    s = mm(qp, kp.transpose(1, 2)) * (1.0 / math.sqrt(dk))
    if causal:
        tpos = q_offset + torch.arange(q.shape[1])
        s = s.masked_fill(tpos[:, None] < torch.arange(k.shape[1])[None, :], -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = mm(p, vp) / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out[..., :dv]


def _normal(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


# -- the rounding ---------------------------------------------------------------


@pytest.mark.parametrize("x,expected", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -12, 1.0),                      # below the tie: down
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),         # the tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),   # ... on both sides
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),     # above the tie: up
    (2.0 - 2.0 ** -23, 2.0),                      # carries into the exponent
])
def test_tf32_rna_rounds_to_nearest_ties_away(x, expected):
    assert tf32_rna(torch.tensor([x], dtype=torch.float32)).item() == expected


def test_split_is_two_tf32_numbers_that_sum_to_x():
    x = _normal(np.random.default_rng(0), 4096) * 10.0
    big, small = split(x)
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    # small carries the next 11 bits: what is left is below 2^-22 of |x|
    assert bool(((big + small - x).abs() <= x.abs() * 2.0 ** -22).all())


# -- attention on the emulated products ----------------------------------------


@pytest.mark.parametrize("BH,T,S,dk,dv,causal", [
    (2, 1024, 1024, 128, 128, True),   # qwen3's head dim, causal
    (2, 256, 256, 192, 128, False),    # MLA: dk != dv
    (1, 17, 33, 20, 20, True),         # dims no multiple of 8: zero-padded
])
def test_3xtf32_attention_within_kernel_tolerance(BH, T, S, dk, dv, causal):
    rng = np.random.default_rng(7)
    q, k, v = _normal(rng, BH, T, dk), _normal(rng, BH, S, dk), _normal(rng, BH, S, dv)
    out = attention_emulated(q, k, v, causal=causal)
    ref = attention_bhsd_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_3xtf32_attention_gqa_q_offset_within_kernel_tolerance():
    """The GQA layout with T != S and q_offset=70, folded as the kernel reads
    it (query head (kh, g) against KV head kh), against gqa_plain."""
    rng = np.random.default_rng(8)
    B, T, S, KH, G, d = 2, 130, 200, 4, 2, 128
    q, k, v = _normal(rng, B, T, KH, G, d), _normal(rng, B, S, KH, d), _normal(rng, B, S, KH, d)
    qb = q.permute(0, 2, 3, 1, 4).reshape(B * KH * G, T, d)
    kb, vb = (x.permute(0, 2, 1, 3)[:, :, None].expand(B, KH, G, S, d).reshape(B * KH * G, S, d)
              for x in (k, v))
    out = attention_emulated(qb, kb, vb, causal=True, q_offset=70)
    out = out.reshape(B, KH, G, T, d).permute(0, 3, 1, 2, 4)
    ref = gqa_plain(q, k, v, causal=True, q_offset=70)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_one_tf32_product_misses_the_tolerance():
    """The control: one TF32 product (tf32(a).tf32(b)) misses 3e-5 at d 128,
    which is why the kernel spends three."""
    rng = np.random.default_rng(7)
    q, k, v = (_normal(rng, 2, 1024, 128) for _ in range(3))
    ref = attention_bhsd_ref(q, k, v, causal=True)
    one = attention_emulated(q, k, v, causal=True, mm=mm_1xtf32)
    three = attention_emulated(q, k, v, causal=True)
    err_one, err_three = float((one - ref).abs().max()), float((three - ref).abs().max())
    assert err_one > TOL["atol"] and not torch.allclose(one, ref, **TOL)
    assert err_three < err_one / 10


# -- the bf16 body: wgmma products, P rounded to bf16 ----------------------------


def attention_bf16_emulated(q, k, v, *, causal: bool, q_offset: int = 0, block_k: int = 128,
                            round_p: bool = True):
    """q (BH, T, dk), k (BH, S, dk), v (BH, S, dv) in bf16: the bf16 body's
    arithmetic, KV tile by KV tile (keys past S and, under ``causal``, after
    the query are -1e30), P rounded to bf16 before P.V unless ``round_p`` is
    False; o = acc / max(l, 1e-30) in bf16."""
    qf, kf, vf = q.float(), k.float(), v.float()
    BH, T, dk = q.shape
    S = k.shape[1]
    scale2 = torch.tensor(1.0 / math.sqrt(dk)) * torch.tensor(LOG2E)   # both fp32
    m = torch.full((BH, T, 1), -1e30)
    l = torch.zeros(BH, T, 1)
    acc = torch.zeros(BH, T, v.shape[-1])
    tpos = q_offset + torch.arange(T)
    for k0 in range(0, S, block_k):
        s = qf @ kf[:, k0:k0 + block_k].transpose(1, 2)
        if causal:
            kpos = torch.arange(k0, min(k0 + block_k, S))
            s = s.masked_fill(kpos[None, :] > tpos[:, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * scale2)
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s * scale2 - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = p.to(torch.bfloat16).float() if round_p else p
        acc = acc * corr + pv @ vf[:, k0:k0 + block_k]
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


def test_bf16_rounding_is_to_nearest_even():
    """torch's float -> bf16 rounds as cvt.rn does: to nearest, ties to even."""
    one, ulp = 1.0, 2.0 ** -7
    x = torch.tensor([one + ulp / 2, one + 3 * ulp / 2, one + ulp / 2 + 2.0 ** -20,
                      -(one + ulp / 2)], dtype=torch.float32)
    assert x.to(torch.bfloat16).float().tolist() == [one, one + 2 * ulp, one + ulp, -one]


@pytest.mark.parametrize("BH,T,S,causal,q_offset", [
    (2, 256, 256, True, 0),      # causal, two KV tiles
    (2, 130, 200, False, 0),     # T != S, S no multiple of the tile
    (2, 130, 200, True, 70),     # queries at q_offset + t
])
def test_bf16_scheme_attention_vs_repro_interpret(BH, T, S, causal, q_offset):
    """The bf16 scheme at head dim 128 against repro's Pallas kernel (interpret
    mode) on the same bf16 inputs: within 3e-2, and reading at most 1e-2,
    about one bf16 rounding of the output; with P kept in fp32 it reads
    less (the rounding of P is the scheme's one new rounding)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention.kernel import flash_attention_bhsd as jax_flash

    rng = np.random.default_rng(11)
    q, k, v = (_normal(rng, *shape).to(torch.bfloat16)
               for shape in ((BH, T, 128), (BH, S, 128), (BH, S, 128)))
    ref = jax_flash(*(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
                    causal=causal, q_offset=q_offset, block_q=64, block_k=64, interpret=True)
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    out = attention_bf16_emulated(q, k, v, causal=causal, q_offset=q_offset).float()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **BF16_TOL)
    err = float((out - ref).abs().max())
    assert err <= 1e-2
    fp32_p = attention_bf16_emulated(q, k, v, causal=causal, q_offset=q_offset, round_p=False)
    assert float((fp32_p.float() - ref).abs().max()) <= err
