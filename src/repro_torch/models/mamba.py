"""Mamba2 (SSD — state-space duality) blocks for prefill and decode.

Port of :mod:`repro.models.mamba`.  Prefill splits the sequence into chunks
of Q tokens: within a chunk a masked, decay-weighted quadratic form, across
chunks the (H, N, P) state carried by a linear recurrence.  ``ssd_impl``
picks ``"chunked"`` (that algorithm in plain PyTorch) or ``"pallas"`` (the
name kept from ``repro``: the hand-written SSD scan kernel,
:mod:`repro_torch.kernels.ssd_scan`).  Decode carries (conv_state,
ssm_state), updated in place: O(1) per token in the context length.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.models.common import Seed, dense_init, init_stream, params, rms_norm

__all__ = ["MambaCache", "SSMConfig", "init_mamba2", "init_mamba_cache", "mamba2_decode",
           "mamba2_forward", "ssd_chunked"]


class SSMConfig(NamedTuple):
    d_model: int
    d_state: int = 128          # N
    head_dim: int = 64          # P
    expand: int = 2
    n_groups: int = 1           # G (B/C shared per group)
    conv_kernel: int = 4
    chunk: int = 128            # Q
    ssd_impl: str = "chunked"   # chunked | pallas (the CUDA kernel)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_mamba2(cfg: SSMConfig, *, dtype=torch.float32, device=None,
                generator: Seed = None) -> nn.ParameterDict:
    generator = init_stream(generator)
    D, DI, H, G, N, K = (cfg.d_model, cfg.d_inner, cfg.n_heads,
                         cfg.n_groups, cfg.d_state, cfg.conv_kernel)
    d_proj = 2 * DI + 2 * G * N + H      # [z, x, B, C, dt]
    kw = dict(in_axis=0, dtype=dtype, device=device, generator=generator)
    f32 = dict(dtype=torch.float32, device=device)
    return params({
        "in_proj": dense_init((D, d_proj), **kw),
        "conv_w": dense_init((K, DI + 2 * G * N), **kw),
        "conv_b": torch.zeros((DI + 2 * G * N,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "dt_bias": torch.zeros((H,), **f32),
        "D": torch.ones((H,), **f32),
        "norm": torch.ones((DI,), dtype=dtype, device=device),
        "out_proj": dense_init((DI, D), **kw),
    })


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d; x (B, T, C), w (K, C)."""
    K, T = w.shape[0], x.shape[1]
    xp = nn.functional.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0:T, :] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + T, :] * w[i]
    return out + b


def _split(proj: torch.Tensor, cfg: SSMConfig):
    """[z (DI), xBC (DI + 2GN), dt (H)] of the input projection."""
    DI, GN = cfg.d_inner, cfg.n_groups * cfg.d_state
    return proj[..., :DI], proj[..., DI:2 * DI + 2 * GN], proj[..., 2 * DI + 2 * GN:]


def mamba2_forward(p, x: torch.Tensor, cfg: SSMConfig) -> torch.Tensor:
    """Train/prefill pass. x (B, T, D) → (B, T, D); T must be a multiple of
    the chunk."""
    B_, T, _ = x.shape
    DI, H, G, N, P = cfg.d_inner, cfg.n_heads, cfg.n_groups, cfg.d_state, cfg.head_dim
    if T % cfg.chunk:
        raise ValueError(f"mamba2_forward needs T % chunk == 0, got T={T}, "
                         f"chunk={cfg.chunk}")

    z, xbc, dt = _split(x @ p["in_proj"], cfg)
    xbc = nn.functional.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :DI].reshape(B_, T, H, P)
    Bmat = xbc[..., DI:DI + G * N].reshape(B_, T, G, N)
    Cmat = xbc[..., DI + G * N:].reshape(B_, T, G, N)
    dt = nn.functional.softplus(dt.float() + p["dt_bias"])

    if cfg.ssd_impl == "pallas":
        y, _ = ssd_ops.ssd(xs, dt, p["A_log"], Bmat, Cmat, chunk=cfg.chunk)
    elif cfg.ssd_impl == "chunked":
        y, _ = ssd_chunked(xs, dt, p["A_log"], Bmat, Cmat, chunk=cfg.chunk)
    else:
        raise ValueError(f"unknown ssd_impl {cfg.ssd_impl!r} (chunked | pallas)")
    y = y + xs * p["D"][None, None, :, None].to(xs.dtype)
    y = y.reshape(B_, T, DI)
    y = rms_norm(y * nn.functional.silu(z), p["norm"])
    return y @ p["out_proj"]


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, K-1, DI + 2GN) — last inputs to the causal conv
    ssm: torch.Tensor   # (B, H, N, P) — the recurrent state


def init_mamba_cache(cfg: SSMConfig, batch: int, dtype=torch.float32,
                     device=None) -> MambaCache:
    DI, H, G, N, P = cfg.d_inner, cfg.n_heads, cfg.n_groups, cfg.d_state, cfg.head_dim
    return MambaCache(
        torch.zeros((batch, cfg.conv_kernel - 1, DI + 2 * G * N), dtype=dtype, device=device),
        torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
    )


def mamba2_decode(p, cache: MambaCache, x_t: torch.Tensor, cfg: SSMConfig):
    """One-token decode: O(1) in context length. x_t (B, 1, D).  Returns
    (cache, y); ``cache`` is updated in place and returned."""
    B_ = x_t.shape[0]
    DI, H, G, N, P = cfg.d_inner, cfg.n_heads, cfg.n_groups, cfg.d_state, cfg.head_dim

    z, xbc_t, dt = _split((x_t @ p["in_proj"])[:, 0], cfg)     # (B, ·)

    # conv over [state, new]
    window = torch.cat([cache.conv, xbc_t[:, None, :]], dim=1)  # (B, K, C)
    conv_out = (window * p["conv_w"][None]).sum(1) + p["conv_b"]
    xbc = nn.functional.silu(conv_out)
    cache.conv.copy_(window[:, 1:, :])

    xs = xbc[..., :DI].reshape(B_, H, P)
    Bmat = xbc[..., DI:DI + G * N].reshape(B_, G, N)
    Cmat = xbc[..., DI + G * N:].reshape(B_, G, N)
    dt = nn.functional.softplus(dt.float() + p["dt_bias"])        # (B, H)

    rep = H // G
    Bh = Bmat.repeat_interleave(rep, dim=1)                         # (B,H,N)
    Ch = Cmat.repeat_interleave(rep, dim=1)
    decay = torch.exp(dt * (-torch.exp(p["A_log"]))[None, :])      # (B,H)
    dBx = torch.einsum("bhn,bhp->bhnp", Bh.float(),
                       (xs * dt[..., None].to(xs.dtype)).float())
    cache.ssm.copy_(cache.ssm * decay[:, :, None, None] + dBx)
    y = torch.einsum("bhn,bhnp->bhp", Ch.float(), cache.ssm)
    y = y.to(x_t.dtype) + xs * p["D"][None, :, None].to(xs.dtype)
    y = y.reshape(B_, 1, DI)
    y = rms_norm(y * nn.functional.silu(z[:, None, :]), p["norm"])
    return cache, y @ p["out_proj"]
