"""DAddAccumulator — STEP §4.4/§5.2, host form, on tensors.

The paper's accumulator: N threads each split a local V-vector into M chunks;
chunk *i* goes to node *i*, which reduces its chunk locally and writes it into
the output shared array.  Total wire traffic drops from ``(2N+1)·V`` (send all
vectors to one node, reduce, send the result back) to ``(N+1)·V``.

Port of the host layer of :mod:`repro.core.accumulator`: the class with the
paper's exact API (``Accumulate(local, len)`` blocking until all N threads
contribute), used by the thread pool, which *accounts traffic per mode* so
the ``(2N+1)·V → (N+1)·V`` claim is assertable in tests.  The SPMD
collectives (``accumulate`` / ``accumulate_scatter``) wait for the SPMD slice
(ROADMAP Queue 1 item 7).

Sparse contract: a contribution is compressed with
:func:`~repro_torch.core.sparse.blocked_topk_sparsify` (or the whole round
with the fused kernel), the reduction sums the scattered pairs, and wire
traffic is ``2 · pair_capacity(V, k)`` elements per contribution plus the
``V``-element republish — the same figures as the JAX package, to the
element.  ``auto`` only selects pairs when they are lossless AND cheaper, so
it never changes results.
"""

from __future__ import annotations

import threading
import time
from enum import Enum
from typing import Optional

import torch

from repro_torch.check import checker as stepcheck
from repro_torch.core import telemetry
from repro_torch.core.sparse import (
    DEFAULT_BLOCK,
    blocked_topk_accumulate,
    blocked_topk_sparsify,
    default_auto_k,
    densify,
    pair_capacity,
    sparse_beneficial_batch,
)
from repro_torch.device import to_tensor


class AccumMode(str, Enum):
    GATHER_ALL = "gather_all"          # (2N+1)V-class strawman
    REDUCE_SCATTER = "reduce_scatter"  # (N+1)V-class, the paper's accumulator
    HIERARCHICAL = "hierarchical"      # §4.5: combine per node, then across
    SPARSE = "sparse"                  # (index,value) pairs
    AUTO = "auto"                      # paper's auto rule


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
                all_ok = bool(sparse_beneficial_batch(flats, k, self.block))
                mode = AccumMode.SPARSE if all_ok else AccumMode.REDUCE_SCATTER
            if mode == AccumMode.SPARSE:
                tc = time.perf_counter() if tracing else 0.0
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
                if tracing:
                    trc.observe("accumulate.compress",
                                (time.perf_counter() - tc) * 1e6)
                self.bytes_transferred += (
                    sum(2 * c for c in self.last_pair_counts) + vec_len)
            else:
                total = flats[0]
                for f in flats[1:]:
                    total = total + f
                total = total.reshape(shape)
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
