"""Shared model building blocks: init, norms, RoPE, losses.

Port of :mod:`repro.models.common`.  Parameters are tensors held in
``nn.ParameterDict``\\ s (or, where a node mixes leaves and sub-trees,
:class:`Tree`\\ s) whose keys are ``repro``'s leaf names, so a
parameter tree carries across by name (:mod:`repro_torch.models.convert`).
Every init draws from an :class:`InitStream`, a seed and a count of the
leaves drawn: each value is a counter-based hash of (seed, leaf, index)
computed in int64 tensor ops on the device the tensor is made on, so a seed
gives the same bits on any device, as ``repro``'s ``init(PRNGKey(seed))``
does on any backend (:func:`draw`).  The losses are the mean next-token cross-entropy, whole
(:func:`softmax_cross_entropy`) or streamed over vocabulary chunks
(:func:`chunked_softmax_cross_entropy`); :func:`bf16_boundary` rounds the
cotangent through bf16 on its way back.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


# -- the random stream -----------------------------------------------------------

_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15                  # splitmix64's increment
_MIX = ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB), (31, None))
DRAW_CHUNK = 1 << 24        # values hashed at a time: 128 MiB of int64 a temporary
_TRUNC = float(np.float32(math.erf(math.sqrt(2.0)) * 2.0 ** -23))   # erf(2/√2) / 2^23


def _signed(c: int) -> int:
    """``c`` mod 2^64 as the int64 that has its bits."""
    c &= _MASK64
    return c - (1 << 64) if c >> 63 else c


def mix64(z: int) -> int:
    """splitmix64's finalizer on a Python int, mod 2^64."""
    z &= _MASK64
    for shift, mult in _MIX:
        z ^= z >> shift
        if mult:
            z = (z * mult) & _MASK64
    return z


def leaf_key(seed: int, leaf: int) -> int:
    """The key of the ``leaf``-th draw from ``seed`` (both taken mod 2^64)."""
    return mix64(mix64(seed) + (leaf + 1) * _GOLDEN)


def hash_bits(key: int, start: int, n: int, device) -> torch.Tensor:
    """int64 (n,): the values ``start .. start + n - 1`` of ``key``'s stream,
    ``mix64(key + (i + 1)·golden)`` with splitmix64's constants.  int64
    products wrap mod 2^64 on the CPU and the card alike; an arithmetic
    shift masked to its low bits is the logical shift the hash wants."""
    z = torch.arange(start + 1, start + n + 1, dtype=torch.int64, device=device)
    z.mul_(_signed(_GOLDEN)).add_(_signed(key))
    for shift, mult in _MIX:
        z.bitwise_xor_(torch.bitwise_right_shift(z, shift).bitwise_and_((1 << (64 - shift)) - 1))
        if mult:
            z.mul_(_signed(mult))
    return z


def _odd_23(z: torch.Tensor) -> torch.Tensor:
    """float32: 2b + 1 - 2^23 of the top 23 bits b of each value, an odd
    integer in (-2^23, 2^23), exact in float32; times 2^-23 it is 2u - 1 of
    a uniform u = (2b + 1)·2^-24 in (0, 1), neither end reached."""
    b = torch.bitwise_right_shift(z, 41).bitwise_and_((1 << 23) - 1)
    return b.mul_(2).add_(1 - (1 << 23)).to(torch.float32)


_CPU_ERFINV_WARM = []


def _warm_cpu_erfinv() -> None:
    """Run the CPU's float64 ``erfinv`` once over a tensor that its thread
    pool splits, before the first real draw: the first such call in a
    process has been seen to give one thread's share a less exact result
    (float64: 1 float32 step in ~7,000 of 3 M values; float32: 1,064 steps),
    and later calls the same bits each time."""
    if not _CPU_ERFINV_WARM:
        torch.linspace(-0.99, 0.99, 1 << 20, dtype=torch.float64).erfinv_()
        _CPU_ERFINV_WARM.append(True)


def _normal(z: torch.Tensor, truncate: bool) -> torch.Tensor:
    """N(0, 1) by the inverse CDF, √2·erfinv(2u − 1); ``truncate``: cut at
    ±2, u drawn between Φ(−2) and Φ(2) (``jax.random.truncated_normal``'s
    construction).  2u − 1 is exact in float32 and its scale by erf(√2) one
    rounding; √2·erfinv runs in float64, rounded once to float32, so the CPU
    and CUDA give the same float32 but where the float64 value lies within
    either's last float64 bits of a float32 rounding boundary (~1 value in
    10^8, one float32 step apart)."""
    v = _odd_23(z).mul_(_TRUNC if truncate else 2.0 ** -23)
    if v.device.type == "cpu":
        _warm_cpu_erfinv()
    x = v.double().erfinv_().mul_(math.sqrt(2.0)).float()
    return x.clamp_(-2.0, 2.0) if truncate else x


def draw(key: int, shape, *, kind: str = "normal", high: int = 0, scale: float = 1.0,
         dtype=torch.float32, device=None) -> torch.Tensor:
    """A tensor of ``shape`` on ``device`` from ``key``'s stream, its values
    in row-major order: ``kind`` "normal" (N(0, 1)), "truncated_normal"
    (N(0, 1) cut at ±2), each times ``scale`` in float32 and cast to
    ``dtype``; or "integers", uniform in [0, ``high``) (the stream's low 63
    bits mod ``high``).  Hashed DRAW_CHUNK values at a time into the output,
    so no temporary is the size of the tensor.  On ``"meta"`` nothing is
    drawn."""
    if kind not in ("normal", "truncated_normal", "integers"):
        raise ValueError(f"unknown kind {kind!r}")
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    flat = out.view(-1)
    for start in range(0, flat.numel(), DRAW_CHUNK):
        n = min(DRAW_CHUNK, flat.numel() - start)
        z = hash_bits(key, start, n, out.device)
        if kind == "integers":
            flat[start:start + n] = z.bitwise_and_((1 << 63) - 1).remainder_(high)
        else:
            x = _normal(z, kind == "truncated_normal")
            del z
            flat[start:start + n] = x.mul_(scale) if scale != 1.0 else x
    return out


class InitStream:
    """The weights' random stream: a seed and the count of leaves drawn.
    Each draw takes the next leaf's key (:func:`leaf_key`), so a model built
    twice from one seed, on any device, draws the same values in the same
    order.  ``torch.Generator``\\ s are read only for their seed
    (:func:`init_stream`)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.leaves = 0

    def next_key(self) -> int:
        key = leaf_key(self.seed, self.leaves)
        self.leaves += 1
        return key

    def draw(self, shape, **kw) -> torch.Tensor:
        """:func:`draw` from the next leaf's key."""
        return draw(self.next_key(), shape, **kw)


Seed = Union[InitStream, torch.Generator, int, None]


def init_stream(seed: Seed = None) -> InitStream:
    """``seed`` as an :class:`InitStream`: a stream itself (drawing on from
    where it is), an int, a ``torch.Generator``'s ``initial_seed()`` (on any
    device: its state is not read), or 0 for ``None``."""
    if isinstance(seed, InitStream):
        return seed
    if isinstance(seed, torch.Generator):
        return InitStream(seed.initial_seed())
    return InitStream(0 if seed is None else seed)


# -- initialisation ------------------------------------------------------------


def _stream(generator) -> InitStream:
    if not isinstance(generator, InitStream):
        raise TypeError("an init takes the model's InitStream (init_stream(seed)), not "
                        f"{type(generator).__name__}: a fresh stream a leaf would draw "
                        "every leaf alike")
    return generator


def dense_init(shape, *, in_axis: int = -2, dtype=torch.float32, device=None,
               generator: Optional[InitStream] = None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at ±2, times 1/√fan_in."""
    std = float(np.float32(1.0 / math.sqrt(shape[in_axis])))
    return _stream(generator).draw(shape, kind="truncated_normal", scale=std, dtype=dtype,
                                   device=device)


def embed_init(shape, *, dtype=torch.float32, device=None,
               generator: Optional[InitStream] = None) -> torch.Tensor:
    """N(0, 1) times 0.02."""
    return _stream(generator).draw(shape, scale=float(np.float32(0.02)), dtype=dtype,
                                   device=device)


def params(tensors: Dict[str, torch.Tensor]) -> nn.ParameterDict:
    """A ``ParameterDict`` of ``tensors`` under their ``repro`` leaf names.
    Serving holds weights fixed, so no gradient is tracked; the train step
    turns it on (:func:`repro_torch.launch.steps.make_train_step`)."""
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class Tree(nn.Module):
    """A node of a parameter tree that holds leaves and sub-trees side by
    side under ``repro``'s names, which neither a ``ParameterDict`` nor a
    ``ModuleDict`` can: an MoE layer's ``router`` and expert weights beside
    its ``shared`` FFN, MTP's ``proj`` beside its block and norms.  Read by
    name as those are (``tree["proj"]``, ``"shared" in tree``)."""

    def __init__(self, leaves: Dict[str, torch.Tensor], children: Dict[str, nn.Module]):
        super().__init__()
        for name, t in leaves.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        for name, m in children.items():
            self.add_module(name, m)

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# -- norms ----------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


# -- rotary embeddings -----------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Half-rotation RoPE (the head dimension split in two halves, not
    interleaved lanes).  x: (..., T, H, D); positions: (..., T)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, device=x.device)             # (D/2,)
    angles = positions[..., :, None].float() * freqs               # (..., T, D/2)
    cos = torch.cos(angles)[..., None, :]                           # (..., T, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- losses -----------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token CE with optional z-loss; logits (..., V), labels (...)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return torch.mean(loss)


def _ce_chunk(hidden, w, labels, base: int, m, lse_acc, label_logit):
    """One vocabulary chunk of the streaming CE: the running max, the
    rescaled sum of exponentials and the label's logit where it falls in
    [base, base + width)."""
    logits = (hidden @ w).float()                                   # (B, T, width)
    width = w.shape[-1]
    m_new = torch.maximum(m, logits.amax(-1))
    lse_acc = lse_acc * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
    in_chunk = (labels >= base) & (labels < base + width)
    local = torch.clamp(labels - base, 0, width - 1)
    picked = torch.gather(logits, -1, local[..., None])[..., 0]
    return m_new, lse_acc, torch.where(in_chunk, picked, label_logit)


def chunked_softmax_cross_entropy(hidden: torch.Tensor, head_w: torch.Tensor,
                                  labels: torch.Tensor, *, chunk: int = 8192,
                                  z_loss: float = 0.0) -> torch.Tensor:
    """Streaming CE: never materialises the (B, T, V) logits.

    Walks the head's vocabulary in chunks, carrying the running max, the
    log-sum-exp and the label logit, as the JAX package's scan does; the last
    chunk is as wide as what is left of V (``repro`` pads it and masks the
    pad to -1e30, which adds nothing).  Under autograd each chunk is
    recomputed in the backward pass (``torch.utils.checkpoint``), so the
    backward holds one chunk's logits at a time too.  hidden (B, T, D),
    head_w (D, V)."""
    B, T, _ = hidden.shape
    V = head_w.shape[-1]
    labels = labels.long()
    m = torch.full((B, T), float("-inf"), device=hidden.device)
    lse_acc = torch.zeros((B, T), device=hidden.device)
    label_logit = torch.zeros((B, T), device=hidden.device)
    grad = torch.is_grad_enabled() and (hidden.requires_grad or head_w.requires_grad)
    for base in range(0, V, chunk):
        w = head_w[:, base:base + chunk]
        if grad:
            m, lse_acc, label_logit = checkpoint(_ce_chunk, hidden, w, labels, base, m,
                                                 lse_acc, label_logit, use_reentrant=False)
        else:
            m, lse_acc, label_logit = _ce_chunk(hidden, w, labels, base, m, lse_acc,
                                                label_logit)
    lse = m + torch.log(torch.clamp_min(lse_acc, 1e-30))
    loss = lse - label_logit
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return torch.mean(loss)


# -- §Perf levers ----------------------------------------------------------------


class _BF16Boundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_boundary(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; casts the cotangent to bf16 in backward.

    Placed at residual-stream block boundaries it forces the backward's
    cotangents (fp32 out of the fp32-internal norms and softmax) down to
    bf16 — in the JAX package, the bytes of the tensor-parallel backward
    all-reduces — at the cost of bf16 gradient precision across blocks."""
    return _BF16Boundary.apply(x)
