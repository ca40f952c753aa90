"""A sparse binary-classification set in CSR form, made on the device from a
seed: rows of a fixed number of nonzeros over features of skewed
popularity, each row of unit length, labels from a hidden linear model.

``cfg["matrix"]`` gives ``rows``, ``features`` and ``nnz``: every row holds
``nnz // rows`` nonzeros, and ``nnz % rows`` rows, drawn at random, one
more, so the set has exactly ``nnz``.  A nonzero's feature is drawn by
popularity: ranks ``k = 1 .. features`` with probability proportional to
``k ** -zipf_exponent`` (by searching the ranks' cumulative sums in fp64),
mapped to feature ids by a random permutation.  A row holds no feature
twice: a draw that repeats one already in its row is drawn again, until
none does.  Each row's features are sorted.  The values are drawn from
(0, 1] and each row is scaled to unit length (in fp64, rounded to fp32).
The labels are Bernoulli(sigmoid(x . theta*)) with theta* of standard
normals, one a feature.

Made in blocks of rows, so that what is held beside the matrix stays a few
hundred MB.  Returns the matrix as its three arrays (``indptr`` int64,
``indices`` int32, ``values`` float32), its width and the labels (float32).
"""

from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 19
MAX_REDRAWS = 64


def _ranks(cdf: torch.Tensor, n: int, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=cdf.device, dtype=torch.float64)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)


def _distinct_ranks(cdf, mask, generator) -> torch.Tensor:
    """(n, width) ranks drawn by popularity, distinct within each row's
    ``mask``ed places (the rest is padding)."""
    n, width = mask.shape
    r = _ranks(cdf, n * width, generator).view(n, width)
    pad = cdf.numel() + torch.arange(width, device=cdf.device)   # distinct, above every rank
    for _ in range(MAX_REDRAWS):
        srt, order = torch.sort(torch.where(mask, r, pad), dim=1)
        dup = srt[:, 1:] == srt[:, :-1]
        if not bool(dup.any()):
            return r
        again = torch.zeros_like(mask).scatter_(1, order[:, 1:], dup)   # each repeat's later places
        r[again] = _ranks(cdf, int(again.sum()), generator)
    raise RuntimeError(f"sparse_rows: rows still repeat a feature after {MAX_REDRAWS} draws")


def make(cfg: dict, generator: torch.Generator, device: torch.device) -> dict:
    """``{"indptr", "indices", "values", "n_features", "y"}`` of
    ``cfg["matrix"]``, drawn from ``generator``."""
    m = cfg["matrix"]
    rows, features, nnz = int(m["rows"]), int(m["features"]), int(m["nnz"])
    base, extra = divmod(nnz, rows)
    width = base + (extra > 0)
    if width > features:
        raise ValueError(f"rows of {width} distinct features out of {features}")
    lengths = torch.full((rows,), base, dtype=torch.int64, device=device)
    lengths[torch.randperm(rows, generator=generator, device=device)[:extra]] += 1
    indptr = torch.zeros(rows + 1, dtype=torch.int64, device=device)
    torch.cumsum(lengths, 0, out=indptr[1:])
    cdf = torch.arange(1, features + 1, dtype=torch.float64, device=device).pow_(
        -float(m["zipf_exponent"])).cumsum_(0)
    cdf /= cdf[-1].clone()
    ids = torch.randperm(features, generator=generator, device=device).to(torch.int32)
    theta_star = torch.randn(features, generator=generator, device=device, dtype=torch.float64)

    indices = torch.empty(nnz, dtype=torch.int32, device=device)
    values = torch.empty(nnz, dtype=torch.float32, device=device)
    y = torch.empty(rows, dtype=torch.float32, device=device)
    places = torch.arange(width, device=device)
    starts = indptr[::BLOCK_ROWS].tolist() + [nnz]
    for i, lo in enumerate(range(0, rows, BLOCK_ROWS)):
        hi = min(rows, lo + BLOCK_ROWS)
        mask = places < lengths[lo:hi, None]
        cols = ids[_distinct_ranks(cdf, mask, generator)].masked_fill_(~mask, features)
        cols = torch.sort(cols, dim=1).values           # the row's features in order, padding last
        v = (1.0 - torch.rand((hi - lo, width), generator=generator, device=device,
                              dtype=torch.float32)).double().mul_(mask)
        v /= v.square().sum(1, keepdim=True).sqrt_()
        v = v.float()
        z = (v.double() * theta_star[cols.clamp(max=features - 1).long()]).mul_(mask).sum(1)
        y[lo:hi] = (torch.rand(hi - lo, generator=generator, device=device,
                               dtype=torch.float64) < torch.sigmoid(z)).float()
        a, b = starts[i], starts[i + 1]
        indices[a:b] = cols[mask]
        values[a:b] = v[mask]
    return {"indptr": indptr, "indices": indices, "values": values, "n_features": features,
            "y": y}
