"""Plain versions of the SSD scan: the chunked algorithm and the recurrence.

Port of :mod:`repro.kernels.ssd_scan.ref` and of ``ssd_chunked`` in
:mod:`repro.models.mamba` (kept here, where the models import it from, so
the kernel's module needs nothing of the model's).
"""

from __future__ import annotations

import torch


def check_chunks(T: int, chunk: int) -> None:
    if chunk < 1 or T % chunk:
        raise ValueError(f"the SSD scan needs T % chunk == 0, got T={T}, chunk={chunk}")


def ssd_scan_plain(xbar: torch.Tensor, a: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   chunk: int):
    """The chunked algorithm on the kernel's inputs: xbar (b,T,H,P), log-decay
    a (b,T,H), B/C (b,T,G,N) → (y (b,T,H,P) in xbar's dtype, final state
    (b,H,N,P) fp32).  Within a chunk: the masked, decay-weighted quadratic
    form; across chunks: the state recurrence, in order."""
    b, T, H, P = xbar.shape
    G, N = B.shape[2], B.shape[3]
    check_chunks(T, chunk)
    Q, nc, rep = chunk, T // chunk, H // G

    Bh = B.repeat_interleave(rep, dim=2).float()       # (b,T,H,N)
    Ch = C.repeat_interleave(rep, dim=2).float()
    xc = xbar.reshape(b, nc, Q, H, P).float()
    ac = a.reshape(b, nc, Q, H).float()
    Bc, Cc = Bh.reshape(b, nc, Q, H, N), Ch.reshape(b, nc, Q, H, N)

    cum = ac.cumsum(2)                                              # (b,nc,Q,H)
    # -- intra-chunk: mask BEFORE exp (the upper triangle has li - lj > 0) --
    li = cum[:, :, :, None, :]
    lj = cum[:, :, None, :, :]
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xbar.device))
    decay = torch.exp((li - lj).masked_fill(~mask[None, None, :, :, None], float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Cc, Bc) * decay
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # -- chunk states ----------------------------------------------------------
    last = cum[:, :, -1:, :]                                        # (b,nc,1,H)
    sdecay = torch.exp(last - cum)                                  # decay j → chunk end
    S = torch.einsum("bcjhn,bcjhp->bchnp", Bc * sdecay[..., None], xc)

    # -- inter-chunk recurrence ------------------------------------------------
    total = torch.exp(last[:, :, 0, :])                             # (b,nc,H)
    h = torch.zeros((b, H, N, P), dtype=torch.float32, device=xbar.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)                                            # state *before* chunk c
        h = h * total[:, c, :, None, None] + S[:, c]
    y_off = torch.einsum("bcihn,bchnp->bcihp", Cc * torch.exp(cum)[..., None],
                         torch.stack(h_prev, dim=1))
    y = (y_diag + y_off).reshape(b, T, H, P).to(xbar.dtype)
    return y, h


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, *, chunk: int):
    """SSD reference: x (b,T,H,P), dt (b,T,H), A_log (H,), B/C (b,T,G,N) →
    (y, final state).  a = dt·(−exp A_log) in fp32, x̄ = x·dt in x's dtype."""
    a = (dt * (-torch.exp(A_log))[None, None, :]).float()
    xbar = x * dt[..., None].to(x.dtype)
    return ssd_scan_plain(xbar, a, B, C, chunk)


def ssd_sequential_ref(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Token-by-token recurrence (the SSM definition).  Slow; small tests only.

    x (b,T,H,P), dt (b,T,H), A_log (H,), B/C (b,T,G,N) → y (b,T,H,P)
    """
    b, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2).float()
    Ch = C.repeat_interleave(rep, dim=2).float()
    a = torch.exp(dt * (-torch.exp(A_log))[None, None, :]).float()   # (b,T,H)
    xbar = (x * dt[..., None]).float()
    s = torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        s = s * a[:, t, :, None, None] + torch.einsum("bhn,bhp->bhnp", Bh[:, t], xbar[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], s))
    return torch.stack(ys, dim=1).to(x.dtype)
