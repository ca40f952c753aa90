"""An independent model of the port's weight stream
(``repro_torch.models.common``'s ``leaf_key`` / ``hash_bits`` / ``draw``),
in numpy uint64 and Python ints, and the ulp distance that
``test_torch_seed.py`` and ``test_torch_seed_card.py`` hold draws to.

splitmix64 (Steele, Lea and Flood, "Fast splittable pseudorandom number
generators", OOPSLA 2014): the value i of a key is the finalizer of
key + (i + 1)·γ mod 2^64."""

import math

import numpy as np

GAMMA = 0x9E3779B97F4A7C15
M1, M2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB
MASK = (1 << 64) - 1
# splitmix64's first three outputs from state 0, as its reference C code prints them
SPLITMIX_SEED0 = (0xE220A8397B1DCDAF, 0x6E789E6AA1B965F4, 0x06C45D188009454F)
# the bounds a draw is held to across devices, in steps of its dtype: the
# CPU's and CUDA's float64 erfinv can round a value that lies at a float32
# rounding boundary to either side (~1 value in 10^8), and a bf16 leaf is
# that float32 rounded once more
F32_ULPS, BF16_ULPS = 1, 1


def finalize(z: int) -> int:
    z = ((z ^ (z >> 30)) * M1) & MASK
    z = ((z ^ (z >> 27)) * M2) & MASK
    return z ^ (z >> 31)


def key_of(seed: int, leaf: int) -> int:
    return finalize((finalize(seed & MASK) + (leaf + 1) * GAMMA) & MASK)


def stream(key: int, start: int, n: int) -> np.ndarray:
    """uint64 (n,): values start .. start + n - 1 of key's stream."""
    i = np.arange(start + 1, start + n + 1, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = np.uint64(key) + i * np.uint64(GAMMA)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(M1)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(M2)
    return z ^ (z >> np.uint64(31))


def normal(z: np.ndarray, truncate: bool) -> np.ndarray:
    """float64 N(0, 1) of the stream by the inverse CDF: the top 23 bits b
    give 2u - 1 = (2b + 1 - 2^23)·2^-23, scaled by erf(√2) in float32 where
    the draw is cut at ±2, then √2·erfinv in float64 (scipy)."""
    from scipy.special import erfinv

    m = (2 * (z >> np.uint64(41)).astype(np.int64) + 1 - (1 << 23)).astype(np.float32)
    scale = np.float32(math.erf(math.sqrt(2.0)) * 2.0 ** -23) if truncate \
        else np.float32(2.0 ** -23)
    v = (m * scale).astype(np.float32)
    x = math.sqrt(2.0) * erfinv(v.astype(np.float64))
    return np.clip(x, -2.0, 2.0) if truncate else x


def ordered(bits: np.ndarray, width: int) -> np.ndarray:
    """Signed-magnitude float bits (as int64) on one integer line, so that
    adjacent floats are adjacent integers across zero too."""
    bits = bits.astype(np.int64)
    sign = np.int64(1) << (width - 1)
    mag = bits & (sign - 1)
    return np.where(bits & sign, -mag, mag)


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in float32 steps between a and b (float32)."""
    a = ordered(np.ascontiguousarray(a, np.float32).view(np.uint32), 32)
    b = ordered(np.ascontiguousarray(b, np.float32).view(np.uint32), 32)
    return int(np.abs(a - b).max()) if a.size else 0


def ulps_bf16(a_bits: np.ndarray, b_bits: np.ndarray) -> int:
    """The same in bf16 steps, from the two tensors' int16 views."""
    a = ordered(np.asarray(a_bits).view(np.uint16), 16)
    b = ordered(np.asarray(b_bits).view(np.uint16), 16)
    return int(np.abs(a - b).max()) if a.size else 0
