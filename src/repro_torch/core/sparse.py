"""Sparse accumulate wire format (§5.2): blocked top-k (index, value) pairs.

Port of :mod:`repro.core.sparse`.  A contribution of length ``n`` is split
into ``nblocks`` blocks of ``block_eff`` entries, each contributing its
``per_block`` largest-|x| entries (``per_block = ceil(k / nblocks)``), so
the pair arrays have a static length whatever the data.  When every block's
nnz fits its per-block quota the representation is lossless — exactly the
condition under which the auto mode may select it.

The integer layout (:func:`block_layout`, :func:`pair_capacity`,
:func:`default_auto_k`) is copied verbatim: wire accounting is derived from
it, and the two packages' ``wire_traffic()`` must agree to the element.

The receive side, :func:`densify`, runs the ``sparse_scatter_add`` kernel
for float32 pairs.  Selection dispatches to the hand-written kernels of
:mod:`repro_torch.kernels` (``impl="kernel"``: the CUDA kernel on the card,
its plain version on the CPU); ``impl="torch"`` keeps a reference written
with ``torch.sort``, independent of the kernels' key packing.  All routes
break ties toward the lower index, as ``jax.lax.top_k`` does, and are
bit-exact with each other and with :mod:`repro.core.sparse`.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.sparse_update.kernel import sparse_scatter_add_unchecked
from repro_torch.kernels.sparse_update.ref import pair_rows

DEFAULT_BLOCK = 1024


# ---------------------------------------------------------------------------
# Selection layout: one formula, used by the sparsifier, the benefit rule and
# the traffic accounting — keep them from drifting apart.
# ---------------------------------------------------------------------------


def block_layout(n: int, k: int, block: int = DEFAULT_BLOCK) -> tuple[int, int, int]:
    """``(nblocks, block_eff, per_block)`` of the blocked top-k selection.

    A length-``n`` vector is split into ``nblocks`` blocks of ``block_eff``
    elements; each block contributes its ``per_block`` largest-|x| entries.
    """
    n, k, block = int(n), int(k), int(block)
    if n <= 0:
        raise ValueError(f"vector length must be positive, got {n}")
    if k <= 0:
        raise ValueError(f"top-k budget must be positive, got {k}")
    block_eff = max(1, min(block, n))
    nblocks = -(-n // block_eff)
    per_block = min(block_eff, max(1, -(-k // nblocks)))
    return nblocks, block_eff, per_block


def pair_capacity(n: int, k: int, block: int = DEFAULT_BLOCK) -> int:
    """Static number of (index, value) pairs a budget-``k`` compression of a
    length-``n`` vector puts on the wire (``nblocks * per_block`` ≈ k).

    This is the figure wire-traffic accounting uses on both backends: under
    jit the pair arrays have exactly this length regardless of the data.
    """
    nblocks, _, per_block = block_layout(n, k, block)
    return nblocks * per_block


def default_auto_k(n: int) -> int:
    """Default budget for ``AccumMode.AUTO`` when none was given: ~V/4, so the
    pairs representation (2·capacity elements) stays under half the dense
    vector whenever it is selected.  Auto is lossless by construction, so a
    defaulted budget never changes results — only which wire format wins."""
    return max(1, int(n) // 4)


# ---------------------------------------------------------------------------
# The shared pair format
# ---------------------------------------------------------------------------


@dataclass
class SparsePairs:
    """Blocked top-k compression of one length-``n`` contribution.

    ``idx`` (int32) / ``vals`` have static length :func:`pair_capacity`;
    positions beyond a block's nnz carry ``(0, 0.0)`` and scatter-add as
    no-ops.  Iterable as ``(idx, vals)`` for tuple-style call sites.
    """

    idx: torch.Tensor
    vals: torch.Tensor
    n: int  # dense vector length

    def __iter__(self):
        yield self.idx
        yield self.vals

    @property
    def num_pairs(self) -> int:
        """Pairs on the wire — the static capacity, not the data's nnz."""
        return int(self.idx.shape[-1])

    @property
    def wire_elements(self) -> int:
        """Wire cost in vector elements: one index + one value per pair."""
        return 2 * self.num_pairs

    def densify(self) -> torch.Tensor:
        """Scatter-add the pairs back into a dense length-``n`` vector."""
        return densify(self.idx, self.vals, self.n)


# ---------------------------------------------------------------------------
# Sparsifiers
# ---------------------------------------------------------------------------


def _pad_blocks(x: torch.Tensor, nblocks: int, block_eff: int):
    """``x`` (..., n) padded and viewed as (..., nblocks, block_eff), plus the
    validity mask of its lanes."""
    n = x.shape[-1]
    xp = torch.nn.functional.pad(x, (0, nblocks * block_eff - n))
    xp = xp.reshape(*x.shape[:-1], nblocks, block_eff)
    valid = (torch.arange(nblocks * block_eff, device=x.device) < n)
    return xp, valid.reshape(nblocks, block_eff)


def _rank_desc(mag: torch.Tensor) -> torch.Tensor:
    """Positions along the last axis in (mag desc, position asc) order — the
    ``jax.lax.top_k`` tie rule: a stable descending sort."""
    return torch.sort(mag, dim=-1, descending=True, stable=True).indices


def topk_sparsify(x: torch.Tensor, k: int):
    """(indices, values) of the k largest-magnitude entries of a 1-D x —
    the unblocked (global sort) form, kept for small vectors and tests.
    Indices are int32 and ties go to the lower index, as ``jax.lax.top_k``
    gives them."""
    if not 0 <= k <= x.shape[0]:
        raise ValueError(f"k must lie in [0, {x.shape[0]}], got {k}")
    idx = _rank_desc(x.abs())[:k]
    return idx.to(torch.int32), x[idx]


def _blocked_topk_torch(x: torch.Tensor, nblocks: int, block_eff: int,
                        per_block: int):
    """torch reference path: same selection schedule as the kernels."""
    xp, valid = _pad_blocks(x, nblocks, block_eff)
    mag = torch.where(valid, xp.float().abs(), -1.0)
    idx = _rank_desc(mag)[:, :per_block]                       # (nblocks, per_block)
    base = (torch.arange(nblocks, device=x.device) * block_eff)[:, None]
    flat_idx = (idx + base).reshape(-1)
    vals = torch.gather(xp, 1, idx).reshape(-1)
    ok = torch.gather(mag, 1, idx).reshape(-1) >= 0
    return flat_idx, torch.where(ok, vals, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def blocked_topk_sparsify(x: torch.Tensor, k: int, block: int = DEFAULT_BLOCK, *,
                          impl: str = "kernel") -> SparsePairs:
    """Compress a 1-D ``x`` to :class:`SparsePairs` under budget ``k``.

    ``impl="kernel"`` (default) dispatches to
    :func:`repro_torch.kernels.topk_compress.ops.topk_compress` — the CUDA
    kernel on the card, its plain version on the CPU; ``impl="torch"`` is the
    stable-sort reference.  Lossless iff every block's nnz fits its
    per-block quota.
    """
    n = x.shape[0]
    nblocks, block_eff, per_block = block_layout(n, k, block)
    if impl == "kernel":
        from repro_torch.kernels.topk_compress.ops import topk_compress
        idx, vals = topk_compress(x, k_per_block=per_block, block_v=block_eff)
    elif impl == "torch":
        idx, vals = _blocked_topk_torch(x, nblocks, block_eff, per_block)
    else:
        raise ValueError(f"impl must be kernel|torch, got {impl!r}")
    # normalise the padded tail: index 0 / value 0 is a harmless scatter-add
    in_range = idx < n
    return SparsePairs(torch.where(in_range, idx, 0).to(torch.int32),
                       torch.where(in_range, vals, torch.zeros((), dtype=vals.dtype,
                                                               device=vals.device)),
                       n)


def densify(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter-add (index, value) pairs into a dense length-n vector.

    ``idx``/``vals`` are 1-D, or (T, P) — one row per thread, added in row
    order — of one shape and device, as one compression per row gives them,
    with int32 or int64 indices.  Float32 pairs go through
    :func:`repro_torch.kernels.sparse_update.kernel.sparse_scatter_add_unchecked`
    (no checks): the CUDA kernel on the card, one launch per call with
    atomic adds and a grid barrier between rows, its plain version (one
    ``index_add_`` per row) on the CPU.  Within one thread's
    pairs the indices are unique apart from ``(0, 0.0)`` padding (adding
    +0.0 to a sum that started at +0.0 changes nothing), so the atomics
    reach the same bits as the JAX package's sequential scatter, thread 0's
    pairs first.  Pairs of any other dtype add in their own type, as the
    JAX package's scatter does (a bf16 scatter rounds after each add, where
    the kernel sums in fp32)."""
    if vals.dtype == torch.float32:
        return sparse_scatter_add_unchecked(idx, vals, n)
    out = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    for i, v in zip(*pair_rows(idx, vals)):
        out.index_add_(0, i.long(), v)
    return out


def blocked_topk_accumulate(mat: torch.Tensor, k: int, block: int = DEFAULT_BLOCK,
                            *, fused: bool = True,
                            impl: str = "kernel") -> torch.Tensor:
    """Sum of the budget-``k`` blocked top-k compressions of each row of a
    stacked (N, V) round — the accumulator's SPARSE/AUTO reduce.

    ``fused=True`` (default) is one
    :func:`~repro_torch.kernels.accumulate.fused_scatter.fused_topk_scatter`
    launch (``impl="torch"`` keeps the stable-sort reference with the same
    selection + left-fold schedule).  ``fused=False`` is compress→densify→add:
    one :func:`blocked_topk_sparsify` per row, then the rows' pairs
    scatter-added in row order.  All routes are bit-exact with each other.
    """
    n_rows, v = mat.shape
    nblocks, block_eff, per_block = block_layout(v, k, block)
    if not fused:
        pairs = [blocked_topk_sparsify(mat[t], k, block, impl=impl)
                 for t in range(n_rows)]
        return densify(torch.stack([p.idx for p in pairs]),
                       torch.stack([p.vals for p in pairs]), v)
    if impl == "kernel":
        from repro_torch.kernels.accumulate.fused_scatter import fused_topk_scatter
        return fused_topk_scatter(mat, per_block=per_block, block_eff=block_eff)
    if impl == "torch":
        return _fused_accumulate_torch(mat, nblocks, block_eff, per_block)
    raise ValueError(f"impl must be kernel|torch, got {impl!r}")


def _fused_accumulate_torch(mat: torch.Tensor, nblocks: int, block_eff: int,
                            per_block: int) -> torch.Tensor:
    """torch reference for the fused kernel: same selection + fold schedule."""
    v = mat.shape[1]
    xp, valid = _pad_blocks(mat.float(), nblocks, block_eff)  # (N, nblocks, block_eff)
    mag = torch.where(valid, xp.abs(), -1.0)
    if per_block < block_eff:
        order = _rank_desc(mag)
        pos = torch.arange(block_eff, device=mat.device)
        thr_pos = order[..., per_block - 1:per_block]
        thr_mag = torch.gather(mag, -1, thr_pos)
        sel = (mag > thr_mag) | ((mag == thr_mag) & (pos <= thr_pos))
    else:
        sel = valid
    contrib = torch.where(sel & valid, xp, 0.0)
    acc = contrib[0]
    for t in range(1, contrib.shape[0]):       # left fold: the kernel's order
        acc = acc + contrib[t]
    return acc.reshape(-1)[:v].to(mat.dtype)


def _beneficial_rows(mat: torch.Tensor, k: int, block: int) -> torch.Tensor:
    """Per row of (R, n): lossless (every block's nnz within quota) AND
    cheaper (2·capacity < n)."""
    n = mat.shape[-1]
    nblocks, block_eff, per_block = block_layout(n, k, block)
    xp, _ = _pad_blocks(mat, nblocks, block_eff)
    per_block_nnz = (xp != 0).sum(dim=-1)
    cheaper = 2 * pair_capacity(n, k, block) < n
    return (per_block_nnz <= per_block).all(dim=-1) & cheaper


def sparse_beneficial(x: torch.Tensor, k: int, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Paper's auto rule, blocked-selection aware: pairs win when the blocked
    top-k is lossless (every block's nnz fits its per-block quota) and the
    pairs are smaller than the dense vector (2·capacity < V)."""
    return _beneficial_rows(x.reshape(1, -1), k, block)[0]


def sparse_beneficial_batch(vectors, k: int, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """The auto rule for a whole accumulator round in one call: True iff
    *every* contribution is losslessly compressible AND cheaper.  One scalar
    for the host to read, instead of one device sync per contribution."""
    mat = torch.stack([torch.as_tensor(v).reshape(-1) for v in vectors])
    return _beneficial_rows(mat, int(k), int(block)).all()
