"""PageRank's credit sum by destination bins (propagation blocking).

One thread's credits are ``credits[v] = sum of w[src] over its edges
(src, v)``, summed in fp64 and rounded once to fp32, where ``w = ranks /
out_deg`` per vertex.  The JAX package has no kernel for it (XLA's scatter
does it); ``csrc/pagerank_credits.cu`` does it on the card in two parts:

* :func:`bin_edges`, the set-up pass once a job: the slice of ``(src, dst)``
  rows (int32 or int64) sorted by counting on ``dst >> BIN_SHIFT`` into one
  int32 copy, and the plan of work items (:func:`bin_plan`, host logic over
  the bins' edge counts).  The caller's slice is only read.
* :func:`binned_credits`, one launch a round: the bins' fp64 sums in shared
  memory, each credit rounded once and written once.

Both take CUDA tensors only: on the CPU ``analytics/pagerank.py`` keeps the
plain ``_credits``, which the kernels are held against on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import build

BIN_SHIFT = 13                  # bins of 8,192 vertices: 64 KB of fp64 partials
BIN = 1 << BIN_SHIFT
# the scatter's first pass groups by buckets of 2^7 bins, so that each CTA
# writes runs of hundreds of edges a bucket; the second groups each bucket
# by bin, a CTA's chunk now spanning one or two buckets' 128 bins
BUCKET_SHIFT = 7
SEGMENT = 1 << 26               # edges staged at a time: a 512 MB staging copy at most
MAX_VERTICES = 2**31 - 1        # vertex ids are int32 in the binned copy
# the kernel's CTA sweeps 512 threads x 4 edges: a piece smaller than one
# sweep leaves threads idle, so no bin is cut below it
PIECE_FLOOR = 512 * 4
INDEX_KINDS = {torch.int32: 0, torch.int64: 1}

launches = build.LaunchCounter("pagerank_credits")
histogram_launches = build.LaunchCounter("pagerank_bin_histogram")   # the set-up pass's
scatter_launches = build.LaunchCounter("pagerank_bin_scatter")       # kernels

_SIGNATURES = {
    "pagerank_bin_histogram": (build.INT, build.PTR, build.LONG, build.LONG, build.INT,
                               build.INT, build.PTR, build.PTR),
    "pagerank_bin_scatter": (build.INT, build.PTR, build.LONG, build.INT, build.INT,
                             build.PTR, build.PTR, build.PTR),
    "pagerank_credits": (build.PTR, build.PTR, build.INT, build.PTR, build.LONG, build.INT,
                         build.PTR, build.PTR, build.PTR, build.PTR, build.PTR),
}


@dataclass(frozen=True)
class BinPlan:
    """Where each bin's edges lie in the binned copy, and the work items.

    ``starts`` (n_bins + 1,): bin b's edges are ``[starts[b], starts[b+1])``.
    ``items`` (n_items, 4) int64, largest first: ``begin, end, bin, slot``;
    slot -1 for a bin that is one item, else the split bin's row of
    scratch, shared by its ``pieces[slot]`` items."""

    starts: np.ndarray
    items: np.ndarray
    pieces: np.ndarray

    @property
    def n_split(self) -> int:
        return int(self.pieces.size)


def bin_plan(counts) -> BinPlan:
    """The plan of a slice whose bins hold ``counts`` edges.

    The unit is the mean count of a bin, or :data:`PIECE_FLOOR` if larger.
    A bin above twice the unit is split into ``ceil(count / unit)`` pieces
    of near-equal size; every other bin is one item.  So no item holds more
    than twice the unit, and a hub's edges, which a CTA adds serially into
    one shared-memory partial, are spread over as many CTAs.  Items are
    ordered largest first (a stable sort), so the split pieces start first
    and are not the launch's tail."""
    counts = np.asarray(counts, dtype=np.int64)
    if counts.ndim != 1 or counts.size == 0 or (counts < 0).any():
        raise ValueError("bin_plan wants a non-empty 1-D histogram of counts >= 0")
    n_bins = counts.size
    starts = np.zeros(n_bins + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    unit = max(-(-int(starts[-1]) // n_bins), PIECE_FLOOR)
    k = np.where(counts > 2 * unit, -(-counts // unit), 1)
    first = np.cumsum(k) - k                        # each bin's first item
    bins = np.repeat(np.arange(n_bins, dtype=np.int64), k)
    piece = np.arange(int(k.sum()), dtype=np.int64) - first[bins]
    count, pieces_of, start = counts[bins], k[bins], starts[bins]
    begin = start + count * piece // pieces_of
    end = start + count * (piece + 1) // pieces_of
    split = k > 1
    slot_of_bin = np.where(split, np.cumsum(split) - 1, -1)
    items = np.stack([begin, end, bins, slot_of_bin[bins]], axis=1)
    order = np.argsort(begin - end, kind="stable")  # largest first
    return BinPlan(starts, np.ascontiguousarray(items[order]), k[split])


@dataclass(frozen=True)
class BinnedEdges:
    """One slice's edges sorted by bin, with the plan, its device copies and
    the split bins' zeroed scratch.  One launch of
    :func:`binned_credits` at a time may use it: the scratch is reused."""

    pairs: torch.Tensor          # (E, 2) int32, grouped by dst >> BIN_SHIFT
    n_vertices: int
    plan: BinPlan
    items: torch.Tensor          # the plan's items on the pairs' device
    pieces: torch.Tensor         # (n_split,) int64
    acc: torch.Tensor            # (n_split * BIN,) float64, zero between launches
    done: torch.Tensor           # (n_split,) int32, zero between launches


def _n_bins(n_vertices: int) -> int:
    return -(-n_vertices // BIN)


def _check_edges(edges: torch.Tensor, n_vertices: int) -> None:
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError("bin_edges wants an (E, 2) tensor of (src, dst) rows, got "
                         f"{tuple(edges.shape)}")
    if edges.dtype not in INDEX_KINDS:
        raise TypeError(f"bin_edges takes int32 or int64 edges, got {edges.dtype}")
    if not edges.is_contiguous():
        raise ValueError("bin_edges takes a contiguous (E, 2) slice of rows")
    if not 1 <= n_vertices <= MAX_VERTICES:
        raise ValueError(f"bin_edges takes 1 <= n_vertices < 2**31, got {n_vertices}")
    if not edges.is_cuda:
        raise ValueError(f"bin_edges runs on the card, not {edges.device}: the CPU takes "
                         "pagerank._credits")


def _binned(pairs: torch.Tensor, n_vertices: int, plan: BinPlan, items: torch.Tensor,
            pieces: torch.Tensor) -> BinnedEdges:
    dev = pairs.device
    return BinnedEdges(pairs, n_vertices, plan, items, pieces,
                       torch.zeros(plan.n_split * BIN, dtype=torch.float64, device=dev),
                       torch.zeros(plan.n_split, dtype=torch.int32, device=dev))


def bin_edges(edges: torch.Tensor, n_vertices: int) -> BinnedEdges:
    """``edges`` (E, 2) int32 or int64, contiguous, sorted by counting on
    ``dst >> BIN_SHIFT`` into a new int32 copy, with its plan.

    Raises on another dtype or shape, a non-contiguous slice, a tensor off
    the card, ``n_vertices`` outside ``[1, 2**31)``, or an index outside
    ``[0, n_vertices)``.  In segments of :data:`SEGMENT` edges: a histogram
    of each, one read of them by the host, then each segment scattered (by
    bucket into a staging copy and that by bin, where there are more bins
    than a bucket holds)."""
    _check_edges(edges, n_vertices)
    if edges.data_ptr() % (2 * edges.element_size()):
        raise ValueError("bin_edges reads each row as one vector: the slice must start "
                         "on a row-pair boundary")
    index = edges.get_device()
    if index != torch.cuda.current_device():   # switch devices only where needed
        with torch.cuda.device(index):
            return bin_edges(edges, n_vertices)
    n_edges, n_bins = edges.shape[0], _n_bins(n_vertices)
    kind = INDEX_KINDS[edges.dtype]
    stream = torch.cuda.current_stream(index).cuda_stream
    lib = build.library("pagerank_credits", _SIGNATURES)
    segments = [edges[lo:lo + SEGMENT] for lo in range(0, max(n_edges, 1), SEGMENT)]
    counts = torch.zeros((len(segments), n_bins + 1), dtype=torch.int64, device=edges.device)
    for seg, row in zip(segments, counts):
        code = lib.pagerank_bin_histogram(kind, seg.data_ptr(), seg.shape[0], n_vertices,
                                          BIN_SHIFT, n_bins, row.data_ptr(), stream)
        if code:
            build.check(lib, "pagerank_bin_histogram", code)
        histogram_launches.add(int(seg.shape[0] > 0))   # an empty slice launches nothing
    counts = counts.cpu().numpy()
    if counts[:, -1].any():
        raise ValueError(f"{int(counts[:, -1].sum())} edge(s) with an index outside "
                         "[0, n_vertices)")
    plan = bin_plan(counts[:, :-1].sum(axis=0))
    two_pass = n_bins > 1 << BUCKET_SHIFT
    # the plan and every cursor in one upload: a copy from pageable memory
    # waits for the stream, and the other threads' work queued on it
    host = [plan.items.ravel(), plan.pieces, plan.starts[:-1]]
    if two_pass:
        buckets = np.add.reduceat(counts[:, :-1], np.arange(0, n_bins, 1 << BUCKET_SHIFT), axis=1)
        host.append((np.cumsum(buckets, axis=1) - buckets).ravel())
    flat = torch.from_numpy(np.concatenate(host)).to(edges.device)
    n_items = plan.items.size
    items, pieces, rest = flat.split([n_items, plan.n_split, flat.numel() - n_items - plan.n_split])
    cursor = rest[:n_bins]                                  # advances over the segments
    pairs = torch.empty((n_edges, 2), dtype=torch.int32, device=edges.device)
    if two_pass:
        staged = torch.empty((min(n_edges, SEGMENT), 2), dtype=torch.int32, device=edges.device)
        bucket_cursors = rest[n_bins:].view(len(segments), -1)
    for i, seg in enumerate(segments):
        src, src_kind = seg, kind
        if two_pass:
            src, src_kind = staged[:seg.shape[0]], INDEX_KINDS[torch.int32]
            _scatter(lib, kind, seg, BIN_SHIFT + BUCKET_SHIFT, bucket_cursors[i], src, stream)
        _scatter(lib, src_kind, src, BIN_SHIFT, cursor, pairs, stream)
    return _binned(pairs, n_vertices, plan, items.view(-1, 4), pieces)


def _scatter(lib, kind: int, edges: torch.Tensor, shift: int, cursor: torch.Tensor,
             out: torch.Tensor, stream: int) -> None:
    """Each row of ``edges`` to ``out`` at ``cursor[dst >> shift]``, which
    advances past it."""
    code = lib.pagerank_bin_scatter(kind, edges.data_ptr(), edges.shape[0], shift,
                                    cursor.numel(), cursor.data_ptr(), out.data_ptr(), stream)
    if code:
        build.check(lib, "pagerank_bin_scatter", code)
    scatter_launches.add(int(edges.shape[0] > 0))


def binned_credits(binned: BinnedEdges, w: torch.Tensor) -> torch.Tensor:
    """(V,) float32 credits of the binned slice: ``w[src]`` summed by
    ``dst`` in fp64, each rounded once to fp32.  ``w`` is (V,) float32,
    contiguous, on the pairs' device (the card).  One launch."""
    v = binned.n_vertices
    if w.dtype != torch.float32 or w.shape != (v,):
        raise TypeError(f"binned_credits wants w of shape ({v},) float32, got "
                        f"{tuple(w.shape)} {w.dtype}")
    if w.device != binned.pairs.device:
        raise ValueError(f"w on {w.device}, the binned edges on {binned.pairs.device}")
    if not w.is_contiguous():
        raise ValueError("binned_credits takes a contiguous w")
    if not w.is_cuda:
        raise ValueError(f"binned_credits runs on the card, not {w.device}")
    index = w.get_device()
    if index != torch.cuda.current_device():   # switch devices only where needed
        with torch.cuda.device(index):
            return binned_credits(binned, w)
    out = torch.empty(v, dtype=torch.float32, device=w.device)
    lib = build.library("pagerank_credits", _SIGNATURES)
    code = lib.pagerank_credits(
        binned.pairs.data_ptr(), binned.items.data_ptr(), binned.items.shape[0], w.data_ptr(), v,
        BIN_SHIFT, binned.acc.data_ptr(), binned.done.data_ptr(), binned.pieces.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(index).cuda_stream)
    if code:
        build.check(lib, "pagerank_credits", code)
    launches.add()
    return out
