"""The flash attention kernel's wrapper (``csrc/flash_attention.cu``).

Port of :mod:`repro.kernels.flash_attention.kernel`.  One launch computes
attention for every (batch, query head) of the GQA layout q (B, T, KH, G,
dk), k (B, S, KH, dk), v (B, S, KH, dv) → (B, T, KH, G, dv): query head
(kh, g) reads KV head kh.  :func:`flash_attention_bhsd` is the TPU kernel's
(BH, T, d) form, the same launch with KH = G = 1.

A CPU tensor takes the plain version (:func:`attention_bhsd_ref` after the
JAX wrapper's fold of (KH, G) into the head axis); a CUDA tensor launches
the kernel or raises.  A meta tensor (the dry run's shapes, no values) runs
the plain version for its shapes and operation counts only; any other
device raises.  Neither is differentiable: ``repro``'s Pallas kernel
has no backward, so a call recorded for a gradient gets an output whose
backward raises (:func:`~repro_torch.kernels.build.forward_only`), on the
card and on the CPU alike.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_bhsd_ref

MAX_HEAD_DIM = 256                 # dk and dv: the kernel's widest instantiation
DTYPES = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}

launches = build.LaunchCounter("flash_attention")
NO_BACKWARD = ("flash_attention has no backward: repro's Pallas kernel defines none, so "
               "the port's kernel defines none either; train with "
               "attention_impl='blocked' (or 'naive')")
# the bf16 body's launches, counted apart as well (each is also one of the above)
launches_bf16 = build.LaunchCounter("flash_attention_bf16")

_ENTRY = (build.PTR, build.PTR, build.PTR, build.PTR, build.INT, build.INT, build.INT,
          build.INT, build.INT, build.INT, build.INT, build.INT, build.INT,
          build.FLOAT, build.PTR)
_SIGNATURES = {"flash_attention_f32": _ENTRY, "flash_attention_bf16": _ENTRY,
               "flash_attention_smem_bytes": (build.INT, build.INT, build.INT)}


def smem_bytes(dk: int, dv: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of one CTA of the body that takes (dk, dv) in ``dtype``
    (float32: the 3xTF32 mma.sync body, bfloat16: the wgmma body), as the
    kernel's source computes it (``flash_attention_smem_bytes``); builds the
    library."""
    lib = build.library("flash_attention", _SIGNATURES)
    return lib.flash_attention_smem_bytes(dk, dv, int(dtype == torch.float32))


def gqa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
              q_offset: int) -> torch.Tensor:
    """The plain version on the GQA layout: fold (KH, G) into the head axis,
    broadcast K/V over G (as the JAX wrapper does) and run the reference."""
    B, T, KH, G, d = q.shape
    S, dv = k.shape[1], v.shape[-1]
    qb = q.permute(0, 2, 3, 1, 4).reshape(B * KH * G, T, d)
    kb = k.permute(0, 2, 1, 3)[:, :, None].expand(B, KH, G, S, d).reshape(B * KH * G, S, d)
    vb = v.permute(0, 2, 1, 3)[:, :, None].expand(B, KH, G, S, dv).reshape(B * KH * G, S, dv)
    out = attention_bhsd_ref(qb, kb, vb, causal=causal, q_offset=q_offset)
    return out.reshape(B, KH, G, T, dv).permute(0, 3, 1, 2, 4)


def _meta(*tensors: torch.Tensor) -> bool:
    """Whether every tensor is a meta tensor (the dry run's shapes)."""
    return all(t.device.type == "meta" for t in tensors)


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention runs on cpu or cuda with q, k, v on one device, "
                         f"got {q.device}, {k.device}, {v.device}")


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (B, T, KH, G, dk); k (B, S, KH, dk); v (B, S, KH, dv) → (B, T, KH, G, dv)
    in q's dtype (fp32 math).  Not differentiable (its backward raises)."""
    if build.differentiated(q, k, v):
        return build.forward_only(NO_BACKWARD, lambda *t: flash_attention_gqa(
            *t, causal=causal, q_offset=q_offset), q, k, v)
    if q.ndim != 5 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention wants q (B, T, KH, G, dk), k (B, S, KH, dk), "
                         f"v (B, S, KH, dv); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, T, KH, G, dk = q.shape
    S, dv = k.shape[1], v.shape[-1]
    if k.shape != (B, S, KH, dk) or v.shape[:3] != (B, S, KH):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if q.device.type == "cpu":
        return gqa_plain(q, k, v, causal=causal, q_offset=q_offset)
    if _meta(q, k, v):
        # shapes only: nothing runs, so the plain version's ops stand in
        return gqa_plain(q, k, v, causal=causal, q_offset=q_offset)
    _check_cuda(q, k, v)
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash_attention kernel takes float32 or bfloat16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if max(dk, dv) > MAX_HEAD_DIM or dk % 4 or dv % 4:
        raise ValueError(f"the flash_attention kernel takes head dims that are multiples "
                         f"of 4, up to {MAX_HEAD_DIM}; got dk={dk}, dv={dv}")
    if q_offset < 0:
        raise ValueError("the flash_attention kernel needs q_offset >= 0 (key 0 visible "
                         f"to every query), got {q_offset}")
    if S == 0:
        raise ValueError("flash_attention needs at least one key")
    out = torch.empty((B, T, KH, G, dv), dtype=q.dtype, device=q.device)
    if B * T * KH * G == 0:
        return out
    # both bodies stage rows with 16-byte cp.async (the bf16 one with 8-byte
    # copies where dk or dv % 8 == 4): a view that starts off a 16-byte
    # boundary is copied into a fresh (aligned) tensor
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    name = DTYPES[q.dtype]
    lib = build.library("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = getattr(lib, name)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                  B, T, S, KH, G, dk, dv, int(bool(causal)), int(q_offset),
                                  1.0 / math.sqrt(dk), build.stream_of(q))
    build.check(lib, name, code)
    launches.add()
    if q.dtype == torch.bfloat16:
        launches_bf16.add()
    return out


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q (BH, T, d), k (BH, S, d), v (BH, S, dv) → (BH, T, dv).  Not
    differentiable (its backward raises)."""
    if build.differentiated(q, k, v):
        return build.forward_only(NO_BACKWARD, lambda *t: flash_attention_bhsd(
            *t, causal=causal, q_offset=q_offset), q, k, v)
    if q.device.type == "cpu" or _meta(q, k, v):
        return attention_bhsd_ref(q, k, v, causal=causal, q_offset=q_offset)
    _check_cuda(q, k, v)
    out = flash_attention_gqa(q[:, :, None, None], k[:, :, None], v[:, :, None],
                              causal=causal, q_offset=q_offset)
    return out[:, :, 0, 0]
