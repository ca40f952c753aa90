"""DAddAccumulator — STEP §4.4/§5.2, in both its host form and its SPMD form.

The paper's accumulator: N threads each split a local V-vector into M chunks;
chunk *i* goes to node *i*, which reduces its chunk locally and writes it into
the output shared array.  Total wire traffic drops from ``(2N+1)·V`` (send all
vectors to one node, reduce, send the result back) to ``(N+1)·V``.

Port of :mod:`repro.core.accumulator`, on tensors.  Two layers:

* **SPMD functions** (``accumulate`` / ``accumulate_scatter`` /
  ``accumulate_tree``) — called inside a mesh position
  (:mod:`repro_torch.core.compat`) by the SPMD backend.  Modes:
  ``gather_all`` (strawman), ``reduce_scatter`` (paper: the owned chunk of
  the sum, then an all_gather), ``hierarchical`` (paper §4.5: over
  ``inner_axis``, then across ``outer_axis``), ``sparse`` (top-k pairs),
  ``auto`` (paper's rule, lossless by construction).  A replicated result —
  the dense sum, the densified pairs — is computed once for the group and
  the same tensor handed to every position.  The JAX package's collective
  never fuses, so neither does this one: a sparse round compresses once per
  position and densifies once.
* **DAddAccumulator** — the host-side class with the paper's exact API
  (``Accumulate(local, len)`` blocking until all N threads contribute), used
  by the thread pool, which *accounts traffic per mode* so the
  ``(2N+1)·V → (N+1)·V`` claim is assertable in tests.

Sparse contract: a contribution is compressed with
:func:`~repro_torch.core.sparse.blocked_topk_sparsify` (or the whole round
with the fused kernel), the reduction sums the scattered pairs, and wire
traffic is ``2 · pair_capacity(V, k)`` elements per contribution plus the
``V``-element republish — the same figures as the JAX package, to the
element.  ``auto`` only selects pairs when they are lossless AND cheaper, so
it never changes results.

Dense contract: the fixed dense modes keep an O(V) running sum, as the JAX
package does; a buffered round (AUTO) that takes the dense branch is folded
in arrival order by the ``accumulate_blocked`` kernel, bit-exact with that
fold for float32.  The SPMD dense sums are collectives in the JAX package,
not kernels, and stay plain sums here.
"""

from __future__ import annotations

import threading
import time
from enum import Enum
from typing import Optional

import torch

from repro_torch.check import checker as stepcheck
from repro_torch.core import telemetry
from repro_torch.core.addressing import align_up
from repro_torch.core.compat import (
    all_gather, all_gather_reduce, axis_size, psum, psum_scatter, tree_map)
from repro_torch.core.sparse import (
    DEFAULT_BLOCK,
    blocked_topk_accumulate,
    blocked_topk_sparsify,
    default_auto_k,
    densify,
    pair_capacity,
    sparse_beneficial,
    sparse_beneficial_batch,
)
from repro_torch.device import to_tensor
from repro_torch.kernels.accumulate.kernel import (
    accumulate_rows_unchecked as accumulate_rows)


def _dense_sum(flats: list) -> torch.Tensor:
    """A buffered round's dense sum: the left fold ``flats[0] + flats[1] +
    …`` in arrival order.  Float32 rounds take the ``accumulate_blocked``
    kernel (its plain version on the CPU), which folds the rows in that
    order in fp32 and so gives the same bits; a round's rows are one shape
    and device by construction, so it goes in without the public wrapper's
    checks.  Rounds of any other dtype keep the JAX package's fold: a bf16
    fold rounds after each add, where the kernel sums in fp32 and rounds
    once."""
    if all(f.dtype == torch.float32 for f in flats):
        return accumulate_rows(flats)
    total = flats[0]
    for f in flats[1:]:
        total = total + f
    return total


class AccumMode(str, Enum):
    GATHER_ALL = "gather_all"          # (2N+1)V-class strawman
    REDUCE_SCATTER = "reduce_scatter"  # (N+1)V-class, the paper's accumulator
    HIERARCHICAL = "hierarchical"      # §4.5: combine per node, then across
    SPARSE = "sparse"                  # (index,value) pairs
    AUTO = "auto"                      # paper's auto rule


# ---------------------------------------------------------------------------
# SPMD layer (inside a mesh position: `axis` names are mesh axes)
# ---------------------------------------------------------------------------


def _pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    n = x.shape[0]
    target = align_up(n, multiple)
    if target == n:
        return x
    return torch.cat([x, x.new_zeros((target - n, *x.shape[1:]))])


def accumulate_scatter(x: torch.Tensor, axis) -> torch.Tensor:
    """Reduce-scatter: this position's owned chunk of the global sum (``x``
    padded to a multiple of the axis size).

    This is the paper's "node i receives chunk i and reduces locally" —
    the primitive behind ZeRO-1 (the owner then updates its optimizer shard).
    """
    xp = _pad_to(x, axis_size(axis))
    return psum_scatter(xp, axis, scatter_dimension=0, tiled=True)


def _gather_chunks(chunk: torch.Tensor, axis, orig_len: int) -> torch.Tensor:
    full = all_gather(chunk, axis, axis=0, tiled=True)
    return full[:orig_len] if full.shape[0] != orig_len else full


def accumulate(
    x: torch.Tensor,
    axis,
    mode: AccumMode | str = AccumMode.REDUCE_SCATTER,
    *,
    inner_axis=None,
    outer_axis=None,
    k: Optional[int] = None,
    with_branch: bool = False,
    tracer: telemetry.Tracer = telemetry.NULL_TRACER,
):
    """Sum `x` over mesh axis(es); every position receives the full result.

    Must be called inside a mesh position.  `x` is the position's local
    vector (leading dim = vector length).  The result is shared by every
    position of the group: never write into it.

    ``with_branch=True`` (``auto`` mode only) additionally returns the
    globally-agreed branch decision as a bool — what the SPMD session
    charges wire traffic by.  ``tracer`` times that decision's device sync
    (a ``device-sync`` span, ``accumulate.decide``) on the position that
    reads it.
    """
    mode = AccumMode(mode)
    if with_branch and mode != AccumMode.AUTO:
        raise ValueError("with_branch reports the auto rule's runtime "
                         f"decision; mode {mode.value!r} has no branch")
    n = x.shape[0]

    if mode == AccumMode.GATHER_ALL:
        # strawman: everyone receives every vector, reduces locally (the one
        # replicated sum is computed once for the group)
        return all_gather_reduce(x, axis, lambda allv: allv.sum(0))

    if mode == AccumMode.REDUCE_SCATTER:
        chunk = accumulate_scatter(x, axis)
        return _gather_chunks(chunk, axis, n)

    if mode == AccumMode.HIERARCHICAL:
        # paper §4.5: one combine inside the node (pod), then across nodes.
        inner = inner_axis if inner_axis is not None else axis
        chunk = accumulate_scatter(x, inner)                 # intra-pod RS
        if outer_axis is not None:
            chunk = psum(chunk, outer_axis)                  # cross-pod on 1/N of data
        return _gather_chunks(chunk, inner, n)               # intra-pod AG

    if mode == AccumMode.SPARSE:
        if k is None:
            raise ValueError("sparse mode needs a top-k budget k")
        pairs = blocked_topk_sparsify(x, k)     # topk_compress, once per position
        # all_gather of the pairs in axis-index order, densified once for the
        # group: one sparse_scatter_add launch a round
        return all_gather_reduce((pairs.idx, pairs.vals), axis,
                                 lambda g: densify(g[0], g[1], n))

    if mode == AccumMode.AUTO:
        if k is None:
            k = default_auto_k(n)
        # the paper's rule must agree across positions: decide on the
        # *global* benefit (all_gather of one flag each), read once
        def decide(oks):
            with telemetry.guarded_span(tracer, "device-sync", "accumulate.decide"):
                return bool(oks.all())
        use_sparse = all_gather_reduce(sparse_beneficial(x, k), axis, decide)
        if use_sparse:
            total = accumulate(x, axis, AccumMode.SPARSE, k=k)
        else:
            total = accumulate(x, axis, AccumMode.REDUCE_SCATTER)
        return (total, use_sparse) if with_branch else total

    raise ValueError(f"unknown accumulator mode: {mode}")


def accumulate_tree(tree, axis, mode=AccumMode.REDUCE_SCATTER, **kw):
    """Accumulate every leaf of a tree (each flattened to 1-D and restored)."""

    def one(leaf):
        flat = leaf.reshape(-1)
        out = accumulate(flat, axis, mode, **kw)
        return out.reshape(leaf.shape)

    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# Host layer: the paper's class API with per-mode traffic accounting
# ---------------------------------------------------------------------------


class DAddAccumulator:
    """Paper-faithful blocking accumulator for the host thread pool.

    ``Accumulate(tid, local_vec)`` blocks until all N threads have contributed,
    then the sum is written into the output shared array in the
    :class:`~repro_torch.core.dsm.GlobalStore`.  Traffic is accounted per the
    paper's cost model so unit tests can assert (N+1)·V vs (2N+1)·V.

    ``mode=SPARSE`` needs a top-k budget ``k``: each thread's contribution is
    compressed to :class:`~repro_torch.core.sparse.SparsePairs`, the round
    sums the scattered pairs, and traffic is ``Σ_threads 2·pairs + V``.
    ``mode=AUTO`` buffers the round, applies the paper's benefit rule to every
    contribution (lossless AND cheaper), and takes the pairs path only when
    all threads agree.  All contributions in a round must have the same
    shape; a ragged contribution raises ``ValueError``, aborts the barrier
    (parked peers get ``BrokenBarrierError``) and poisons the accumulator —
    subsequent rounds raise ``RuntimeError`` instead of publishing.

    Contributions move to the store's device on arrival.  A contribution is
    the caller's own tensor, so the running sum of the dense modes is always
    a new tensor, never an in-place add into the first contribution.
    """

    def __init__(self, store, output_name: str, n_threads: int, n_nodes: int,
                 mode: AccumMode | str = AccumMode.REDUCE_SCATTER, *,
                 k: Optional[int] = None, block: int = DEFAULT_BLOCK,
                 fused: bool = True, tracer=None, checker=None):
        self.store = store
        self.tracer = tracer if tracer is not None else telemetry.NULL_TRACER
        self.checker = checker if checker is not None else stepcheck.NULL_CHECKER
        self.output_name = output_name
        self.n = n_threads
        self.m = max(1, n_nodes)
        self.mode = AccumMode(mode)
        if self.mode == AccumMode.SPARSE and k is None:
            raise ValueError("sparse mode needs a top-k budget k")
        self.k = k                  # AUTO with k=None defaults per round (~V/4)
        self.block = block
        # fused=True applies SPARSE/AUTO pairs rounds as one sparsify→
        # scatter-add kernel launch (bit-exact, same wire accounting);
        # fused=False keeps the compress→densify→add path
        self.fused = fused
        self._owner = None          # memoised (ring_version, shard) of output
        self._lock = threading.Lock()
        self._vecs: list = []           # buffered contributions (SPARSE/AUTO)
        self._partial = None            # running sum (fixed dense modes)
        self._count = 0
        self._round_len: Optional[int] = None
        self._round_shape: Optional[tuple] = None
        self._barrier = threading.Barrier(n_threads)
        self._broken = False        # poisoned by an aborted round
        self.bytes_transferred = 0  # wire-traffic in vector *elements*
        self.rounds = 0
        self.last_mode: Optional[AccumMode] = None  # branch taken last round
        self.last_pair_counts: list = []  # per-thread pairs shipped last round

    # modes that can never take the pairs branch keep a running sum — O(V)
    # peak memory per round; SPARSE/AUTO must buffer the N contributions
    _DENSE_MODES = (AccumMode.GATHER_ALL, AccumMode.REDUCE_SCATTER,
                    AccumMode.HIERARCHICAL)

    def _account_dense(self, vec_len: int) -> None:
        if self.mode == AccumMode.GATHER_ALL:
            # every thread ships V to the root; root ships V back to each: (2N+1)V
            self.bytes_transferred += (2 * self.n + 1) * vec_len
        else:
            # each thread ships its V once (chunked to owners); owners write V
            self.bytes_transferred += (self.n + 1) * vec_len

    def _abort_round(self) -> None:
        self._broken = True
        self._barrier.abort()

    def _reset_round(self) -> None:
        self._vecs = []
        self._partial = None
        self._count = 0
        self._round_len = None
        self._round_shape = None

    def _reduce_round(self) -> None:
        """Runs under the lock when the round's last contribution arrives."""
        trc = self.tracer
        tracing = telemetry.TRACING and trc.enabled
        t0 = time.perf_counter() if tracing else 0.0
        wire_before = self.bytes_transferred
        vec_len, shape = self._round_len, self._round_shape
        if self.mode in self._DENSE_MODES:
            total = self._partial
            self.last_pair_counts = []
            self._account_dense(vec_len)
            mode = self.mode
        else:
            k = self.k if self.k is not None else default_auto_k(vec_len)
            # compression works on flat vectors (scalars and matrices ride
            # along flattened, mirroring the SPMD ctx's rank normalisation)
            flats = [v.reshape(-1) for v in self._vecs]
            mode = self.mode
            if mode == AccumMode.AUTO:
                # pairs only when every contribution is losslessly
                # compressible AND cheaper: one call decides the whole round,
                # a single device sync instead of N small ones
                with telemetry.guarded_span(trc, "device-sync", "accumulate.decide"):
                    all_ok = bool(sparse_beneficial_batch(flats, k, self.block))
                mode = AccumMode.SPARSE if all_ok else AccumMode.REDUCE_SCATTER
            if mode == AccumMode.SPARSE:
                if self.fused:
                    # one fused sparsify→scatter-add launch over the stacked
                    # round; the logical pair count is the static capacity
                    # either way, so wire accounting is unchanged
                    total = blocked_topk_accumulate(
                        torch.stack(flats), k, self.block).reshape(shape)
                    self.last_pair_counts = (
                        [pair_capacity(vec_len, k, self.block)] * self.n)
                else:
                    pairs = [blocked_topk_sparsify(f, k, self.block)
                             for f in flats]
                    # thread 0's pairs first, as the JAX scatter adds them
                    total = densify(torch.stack([p.idx for p in pairs]),
                                    torch.stack([p.vals for p in pairs]),
                                    vec_len).reshape(shape)
                    self.last_pair_counts = [p.num_pairs for p in pairs]
                self.bytes_transferred += (
                    sum(2 * c for c in self.last_pair_counts) + vec_len)
            else:
                total = _dense_sum(flats).reshape(shape)
                self.last_pair_counts = []
                self._account_dense(vec_len)
        self.last_mode = mode
        self._store_output(total)
        self.rounds += 1
        if tracing:
            if mode == AccumMode.SPARSE:
                path = "fused" if self.fused else "sparse"
            else:
                path = "dense"
            trc.count(f"accum.kernel_path.{path}")
            trc.count("accumulate.rounds")
            trc.count("accumulate.wire_elements",
                      self.bytes_transferred - wire_before)
            trc.add_span("accumulate-round", "accumulate.round", t0,
                         time.perf_counter(),
                         {"mode": mode.value, "vec_len": vec_len,
                          "threads": self.n,
                          "pairs": sum(self.last_pair_counts),
                          "wire_elements":
                              self.bytes_transferred - wire_before})
        self._reset_round()

    def _store_output(self, total) -> None:
        """Publish the round sum, with the output's owner shard memoised."""
        store = self.store
        handle = self._owner
        if handle is None or handle.version != store.ring_version:
            handle = store.owner_handle(self.output_name)
            self._owner = handle
        store.set(self.output_name, total, owner=handle)

    def accumulate(self, local_vec) -> None:
        """Paper's ``Accumulate`` — synchronization point across all N threads.

        With an armed tracer, each call records one per-thread span (category
        ``accumulate-round``, name ``accumulate``, entry→barrier release) plus
        a ``barrier-wait`` span for the time parked on the round barrier; the
        round-closing thread additionally records the ``accumulate.round``
        reduce span from :meth:`_reduce_round`."""
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled:
            # publish this thread's clock into the round edge; the collective
            # output write is recorded at the publish-time epoch after the
            # round barrier releases, so peers' post-join clocks dominate it
            token = ck.acc_begin(self)
            self._accumulate_traced(local_vec)
            ck.acc_done(self, self.output_name, token)
            return
        self._accumulate_traced(local_vec)

    def _accumulate_traced(self, local_vec) -> None:
        trc = self.tracer
        if telemetry.TRACING and trc.enabled:
            t0 = time.perf_counter()
            self._accumulate(local_vec, trc)
            trc.wait_span("accumulate-round", "accumulate", t0)
        else:
            self._accumulate(local_vec, None)

    def _accumulate(self, local_vec, trc) -> None:
        local_vec = to_tensor(local_vec, self.store.device)
        with self._lock:
            if self._broken:
                # the barrier was aborted by an earlier error; without this
                # guard a later round would publish its sum to the store and
                # THEN raise BrokenBarrierError in every thread
                raise RuntimeError(
                    "DAddAccumulator is unusable after an aborted round — "
                    "create a fresh accumulator")
            if self._count == 0:
                self._round_shape = tuple(local_vec.shape)
                self._round_len = int(local_vec.numel())
            elif tuple(local_vec.shape) != self._round_shape:
                # release threads already parked on the barrier, drop the
                # poisoned round, then surface
                self._abort_round()
                shape = self._round_shape
                self._reset_round()
                raise ValueError(
                    f"ragged accumulate contribution: round opened with shape "
                    f"{shape}, got {tuple(local_vec.shape)} — all threads must "
                    "contribute identically-shaped vectors")
            if self.mode in self._DENSE_MODES:
                self._partial = (local_vec if self._partial is None
                                 else self._partial + local_vec)
            else:
                self._vecs.append(local_vec)
            self._count += 1
            if self._count == self.n:
                try:
                    self._reduce_round()
                except BaseException:
                    # never strand the N-1 threads parked on the barrier
                    self._abort_round()
                    self._reset_round()
                    raise
        if trc is not None:
            tb = time.perf_counter()
            self._barrier.wait()
            trc.wait_span("barrier-wait", "accumulate.barrier", tb)
        else:
            self._barrier.wait()

    # paper-cased alias
    Accumulate = accumulate
