"""step.Session — the paper's Table 1 as ONE facade over DSM, threads and sync.

Port of :mod:`repro.core.session`, host backend.  A :class:`Session` owns the
:class:`~repro_torch.core.dsm.GlobalStore`, the directory-based DSM cache,
the sync factories and the accumulator registry; shared data is declared
through it and handled via typed :class:`SharedRef` handles::

    sess = Session(n_nodes=2, threads_per_node=2)      # on the card
    grad = sess.new_array("grad", (d,))

    def thread_proc(ctx, xs, ys):          # ctx: tid / guard / iterate
        def step(theta):                   # one synchronous round
            total = grad.accumulate(local_grad(theta, xs, ys))
            return theta + lr * total
        return ctx.iterate(step, torch.zeros(d, device=ctx.device), iters)

    thetas = sess.run(thread_proc, data=(x, y))

``backend="host"`` — :class:`HostBackend` — is the paper's programming model:
``DThreadPool`` threads, blocking ``DAddAccumulator`` rounds, reads served
through the write-invalidate DSM cache, barrier-based release.  The SPMD
backend and ``lower()`` wait for the SPMD slice (ROADMAP Queue 1 item 7);
``findings``, ``watchdog`` and ``openmetrics`` wait for step.check and
step.obs (item 8).

Everything a session holds lives on its ``device``: ``device=None`` is the
card (see :func:`~repro_torch.device.resolve_device`), and ``spawn`` moves
``data=`` and ``broadcast=`` there once, so the dataset lives on the card.

The bulk-synchronous contract: within ``thread_proc``, ``ref.set(v)`` must be
called with a value that is identical across threads (all threads re-derive
the update from the accumulated total).
"""

from __future__ import annotations

import threading
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch import obs as stepobs
from repro_torch.check import checker as stepcheck
from repro_torch.core import telemetry
from repro_torch.core.accumulator import AccumMode, DAddAccumulator
from repro_torch.core.cache import CacheStats, DSMCache
from repro_torch.core.dsm import GlobalStore
from repro_torch.core.sync import DBarrier, DSemaphore, SSPClock
from repro_torch.core.threads import DThreadPool, ThreadState
from repro_torch.data.pipeline import partition_rows
from repro_torch.device import resolve_device, to_tensor


# ---------------------------------------------------------------------------
# Handles
# ---------------------------------------------------------------------------


class SharedRef:
    """Typed handle to one piece of shared data in a session's DSM.

    Table 1's access verbs live here: ``get``/``set``/``inc``/``accumulate``.
    Outside a worker they hit the store directly; inside ``Session.spawn`` they
    are routed through the worker's context (cache-validated reads and
    blocking accumulator rounds).
    """

    __slots__ = ("_session", "name", "_hcache")

    def __init__(self, session: "Session", name: str):
        self._session = session
        self.name = name
        self._hcache = None  # memoised OwnerHandle, refreshed on ring bumps

    def _owner(self):
        """This name's memoised :class:`~repro_torch.core.shards.OwnerHandle`
        (swapped atomically when the ring version moves)."""
        store = self._session.store
        handle = self._hcache
        if handle is None or handle.version != store.ring_version:
            handle = store.owner_handle(self.name)
            self._hcache = handle
        return handle

    def get(self):
        """``Get`` — current value (cache-validated inside host workers).
        The returned tensor is shared: never write into it."""
        return self._session._read(self.name, owner=self._owner())

    def set(self, value) -> None:
        """``Set`` — write-through + invalidate.  Inside a worker this is the
        bulk-synchronous collective write: every thread passes the identical
        re-derived value."""
        self._session._write(self.name, value, owner=self._owner())

    def inc(self, amount=1):
        """``Inc`` — atomic increment; bypasses the cache layer (§5.1).  N
        threads calling ``inc(a)`` advance the value by ``N·a``; each gets its
        own post-increment snapshot."""
        return self._session._inc(self.name, amount, owner=self._owner())

    def accumulate(self, local, *, mode: Optional[AccumMode | str] = None,
                   k: Optional[int] = None):
        """``Accumulate`` — contribute this thread's vector, return the global
        sum.  A synchronization point across all threads (§4.4)."""
        return self._session._accumulate(self.name, local, mode, k)

    def delete(self) -> None:
        """``DelArray`` / ``DelObj`` — also purges cache replicas and
        directory records."""
        self._session.delete(self.name)

    @property
    def address(self) -> int:
        """64-bit DSM address (``object_id ++ field_id``)."""
        return self._session.store.address(self.name)

    @property
    def epoch(self) -> int:
        return self._session.store.epoch(self.name)

    @property
    def shard(self) -> int:
        """Owning shard id under the store's consistent-hash ring."""
        return self._session.store.shard_of(self.name)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"SharedRef({self.name!r}, addr=0x{self.address:x})"

    # paper-cased aliases
    Get = get
    Set = set
    Inc = inc
    Accumulate = accumulate


# ---------------------------------------------------------------------------
# Worker contexts (what thread_proc sees)
# ---------------------------------------------------------------------------


class WorkerCtx:
    """One STEP thread's view of the session: identity, device, sync, ref-op
    routing, and the iteration engine."""

    def __init__(self, session: "Session", tid, n_threads: int, node_id):
        self._session = session
        self.tid = tid
        self.n_threads = n_threads
        self.node_id = node_id

    @property
    def device(self) -> torch.device:
        """Where the session's tensors live — allocate step state here."""
        return self._session.device

    # -- sync ----------------------------------------------------------------

    def guard(self) -> None:
        """Checkpoint boundary: raise inside threads whose node was failed."""
        return None

    def barrier(self, timeout: Optional[float] = None) -> bool:
        return True

    # -- tracing -------------------------------------------------------------

    def span(self, name: str, **args):
        """A user-labelled span (category ``app-round``) on this thread's
        timeline — the hook the analytics apps use to mark one round."""
        return telemetry.NULL_SPAN

    # -- iteration engine ----------------------------------------------------

    def iterate(self, step: Callable, carry, iters: int):
        """Run ``carry = step(carry)`` for ``iters`` synchronous rounds."""
        return self.fori(lambda i, c: step(c), carry, iters)

    def fori(self, step: Callable, carry, iters: int):
        """Indexed variant: ``carry = step(i, carry)`` for i in [0, iters)."""
        raise NotImplementedError

    # -- ref-op routing ------------------------------------------------------

    def read(self, name: str, owner=None):
        raise NotImplementedError

    def write(self, name: str, value, owner=None) -> None:
        raise NotImplementedError

    def inc(self, name: str, amount, owner=None):
        raise NotImplementedError

    def accumulate(self, name: str, local, mode: AccumMode, k: Optional[int]):
        raise NotImplementedError


class HostWorkerCtx(WorkerCtx):
    """One DThread's view: cache-validated reads, blocking accumulator rounds,
    and a plain ``guard()``-per-round iteration loop."""

    def __init__(self, session: "Session", backend: "HostBackend", tid: int):
        super().__init__(session, tid, backend.n_threads,
                         tid // backend.pool.threads_per_node)
        self._backend = backend

    def guard(self) -> None:
        """Raise inside threads whose node was failed (checkpoint boundary)."""
        self._backend.pool.checkpoint_guard(self.tid)

    def barrier(self, timeout: Optional[float] = None) -> bool:
        return self._backend.run_barrier.enter(timeout)

    def span(self, name: str, **args):
        trc = self._session.tracer
        if telemetry.TRACING and trc.enabled:
            return trc.span("app-round", name, **args)
        return telemetry.NULL_SPAN

    def fori(self, step: Callable, carry, iters: int):
        for i in range(int(iters)):
            self.guard()
            carry = step(i, carry)
        return carry

    def read(self, name: str, owner=None):
        return self._session.cache.read(self.node_id, name, owner=owner)

    def write(self, name: str, value, owner=None) -> None:
        self._session.cache.write(self.node_id, name, value, owner=owner)

    def inc(self, name: str, amount, owner=None):
        # atomicity comes from the owning shard's lock inside store.inc
        return self._session.cache.atomic_inc(name, amount, owner=owner)

    def accumulate(self, name: str, local, mode: AccumMode, k: Optional[int]):
        accu = self._backend.accumulator(self._session, name, mode, k)
        accu.accumulate(local)
        return self.read(name)


def _warn_at_caller(message: str, category) -> None:
    """Warn with the first stack frame *outside this module* as the location."""
    import sys
    level, frame = 2, sys._getframe(1)
    while frame is not None and frame.f_globals.get("__name__") == __name__:
        frame = frame.f_back
        level += 1
    warnings.warn(message, category, stacklevel=level)


# ---------------------------------------------------------------------------
# Backend
# ---------------------------------------------------------------------------


class HostBackend:
    """The paper-faithful path: DThreadPool + blocking DAddAccumulator."""

    kind = "host"

    def __init__(self, n_nodes: int = 2, threads_per_node: int = 2, *,
                 fused: bool = True):
        self.pool = DThreadPool(n_nodes, threads_per_node)
        self.run_barrier = DBarrier(self.pool.n_threads)
        # SPARSE/AUTO rounds reduce through the fused sparsify→scatter-add
        # kernel; False routes new accumulators down compress→densify→add
        # (bit-exact either way)
        self.fused = fused
        self._accumulators: Dict[tuple, DAddAccumulator] = {}
        self._lock = threading.Lock()

    @property
    def n_threads(self) -> int:
        return self.pool.n_threads

    @property
    def n_nodes(self) -> int:
        return self.pool.n_nodes

    def accumulator(self, session: "Session", name: str,
                    mode: Optional[AccumMode] = None,
                    k: Optional[int] = None) -> DAddAccumulator:
        """Registry: one accumulator per (output ref, mode, k budget), created
        on first use.  ``mode=None`` resolves to the ref's sole existing
        accumulator, else the session default; ``k=None`` resolves to the
        ref's declared ``sparse_k`` budget."""
        with self._lock:
            if mode is None:
                existing = [a for (n, _, _), a in self._accumulators.items()
                            if n == name]
                if len(existing) == 1:
                    return existing[0]
                mode = session.accum_mode
            mode = AccumMode(mode)
            if k is None:
                k = session.sparse_k(name)
            key = (name, mode, k)
            accu = self._accumulators.get(key)
            if accu is None and k is None:
                # budget-less inspection of a ref that accumulated with a
                # per-call k: resolve to the sole (name, mode) accumulator
                matches = [a for (n, m, _), a in self._accumulators.items()
                           if n == name and m == mode]
                if len(matches) == 1:
                    return matches[0]
            if accu is None:
                accu = DAddAccumulator(session.store, name, self.n_threads,
                                       self.n_nodes, mode, k=k,
                                       fused=self.fused,
                                       tracer=session.tracer)
                self._accumulators[key] = accu
            return accu

    def spawn(self, session: "Session", thread_proc: Callable,
              data: Sequence, broadcast: Sequence) -> None:
        n = self.n_threads

        def entry(tid: int, _param):
            lo_hi = [partition_rows(a.shape[0], tid, n) for a in data]
            shards = [a[lo:hi] for a, (lo, hi) in zip(data, lo_hi)]
            ctx = HostWorkerCtx(session, self, tid)
            if telemetry.TRACING and session.tracer.enabled:
                session.tracer.bind_thread(tid, ctx.node_id)
            session._tls.ctx = ctx
            try:
                return thread_proc(ctx, *shards, *broadcast)
            finally:
                session._tls.ctx = None

        self.pool.create_threads(entry)
        self.pool.start_all()

    def join(self, session: "Session", timeout: Optional[float] = None) -> List[Any]:
        self.pool.join_all(timeout)
        # a thread_proc that raised must not dissolve into a None result
        failed = [t for t in self.pool.threads if t.state is ThreadState.FAILED]
        if failed:
            raise RuntimeError(
                f"{len(failed)} session thread(s) failed; first: tid "
                f"{failed[0].tid} on node {failed[0].node_id}") from failed[0].error
        return [t.result for t in self.pool.threads]

    def wire_traffic(self) -> int:
        with self._lock:
            return sum(a.bytes_transferred for a in self._accumulators.values())


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------


class Session:
    """Table 1 as one object: DSM + cluster/thread management + sync.

    Parameters
    ----------
    backend:
        ``"host"`` or a :class:`HostBackend` instance.
    n_nodes / threads_per_node:
        Host-backend cluster shape.
    device:
        Where shared data and spawned datasets live; ``None`` is the card,
        and raises on a host without a visible GPU.
    accum_mode:
        Default :class:`AccumMode` for ``SharedRef.accumulate``.
    store:
        Optionally adopt an existing :class:`GlobalStore` (its device wins
        when ``device`` is None).
    shards:
        Number of consistent-hash shards in a freshly built store.
    trace:
        ``True`` arms a fresh :class:`~repro_torch.core.telemetry.Tracer`, a
        tracer is adopted as-is, ``None`` leaves tracing off.  A test that
        arms one disables it before returning.
    check / record / cold_tier / cold_budget:
        Accepted for signature parity; anything but ``None`` raises
        ``NotImplementedError`` until step.check, step.obs and tiers land.
    """

    def __init__(self, backend: HostBackend | str = "host", *,
                 n_nodes: int = 2, threads_per_node: int = 2,
                 device=None,
                 store: Optional[GlobalStore] = None,
                 granularity: str = "coarse",
                 shards: int = 1,
                 cold_tier=None,
                 cold_budget: Optional[int] = None,
                 accum_mode: AccumMode | str = AccumMode.REDUCE_SCATTER,
                 cache_capacity: int = 1024,
                 trace: "telemetry.Tracer | bool | None" = None,
                 check=None,
                 record=None):
        if isinstance(backend, str):
            if backend == "host":
                backend = HostBackend(n_nodes, threads_per_node)
            elif backend == "spmd":
                raise NotImplementedError(
                    "the SPMD backend is not ported yet (ROADMAP Queue 1 "
                    "item 7); use backend='host'")
            else:
                raise ValueError(f"backend must be host|spmd, got {backend!r}")
        self.backend = backend
        self.checker = stepcheck.as_checker(check)
        self.recorder = stepobs.as_recorder(record)
        self.tracer = telemetry.as_tracer(trace)
        self.recorder.attach(self.tracer)
        if store is not None:
            if device is not None and resolve_device(device) != store.device:
                raise ValueError(f"device {device} differs from the adopted "
                                 f"store's {store.device}")
            self.store = store
        else:
            self.store = GlobalStore(device, granularity=granularity,
                                     shards=shards, cold_tier=cold_tier,
                                     cold_budget=cold_budget)
        self.device = self.store.device
        self.store.tracer = self.tracer
        self.accum_mode = AccumMode(accum_mode)
        self.cache = DSMCache(self.store, n_nodes=backend.n_nodes,
                              capacity=cache_capacity)
        self.cache.tracer = self.tracer
        backend.run_barrier.tracer = self.tracer
        self._sparse_k: Dict[str, int] = {}  # per-ref default top-k budgets
        self._tls = threading.local()

    # -- Table 1: DSM manipulation --------------------------------------------

    def def_global(self, name: str, value, *,
                   sparse_k: Optional[int] = None) -> SharedRef:
        """``DefGlobal`` — declare + initialise a shared variable.
        ``sparse_k`` sets the ref's default top-k budget for sparse/auto
        accumulates."""
        self.store.def_global(name, value)
        self._set_sparse_k(name, sparse_k)
        return SharedRef(self, name)

    def new_array(self, name: str, shape, dtype=torch.float32, *,
                  sparse_k: Optional[int] = None) -> SharedRef:
        """``NewArray`` — allocate a zeroed shared array.  ``sparse_k`` is the
        ref's default top-k budget for sparse/auto accumulates."""
        self.store.new_array(name, shape, dtype)
        self._set_sparse_k(name, sparse_k)
        return SharedRef(self, name)

    def _set_sparse_k(self, name: str, sparse_k: Optional[int]) -> None:
        self._sparse_k.pop(name, None)  # re-declared names drop the old budget
        if sparse_k is not None:
            if sparse_k < 1:
                raise ValueError(f"sparse_k must be >= 1, got {sparse_k}")
            self._sparse_k[name] = int(sparse_k)

    def sparse_k(self, name: str) -> Optional[int]:
        """The ref's declared default top-k budget (None if unset)."""
        return self._sparse_k.get(name)

    def new_object(self, name: str, fields: Dict[str, Any]) -> SharedRef:
        """``NewObj`` — a shared dict of fields under one object_id."""
        self.store.new_object(name, fields)
        return SharedRef(self, name)

    def ref(self, name: str) -> SharedRef:
        """Handle to an already-declared name."""
        if name not in self.store.names():
            raise KeyError(name)
        return SharedRef(self, name)

    def names(self) -> List[str]:
        return self.store.names()

    def delete(self, name: str) -> None:
        """``DelArray`` / ``DelObj`` + coherence teardown: the store's delete
        hook (the cache's :meth:`DSMCache.drop`) purges every replica and
        directory record under the owning shard's lock."""
        self.store.delete(name)
        self._sparse_k.pop(name, None)

    # -- Table 1: cluster & thread management ---------------------------------

    def spawn(self, thread_proc: Callable, *, data: Sequence = (),
              broadcast: Sequence = ()) -> None:
        """Create + start one STEP thread per backend slot.

        ``thread_proc(ctx, *data_shards, *broadcast)`` receives this thread's
        contiguous row-partition of each array in ``data`` and every array in
        ``broadcast`` whole.  Both move to the session's device once, here.
        """
        data = tuple(to_tensor(a, self.device) for a in data)
        broadcast = tuple(to_tensor(b, self.device) for b in broadcast)
        self.backend.spawn(self, thread_proc, data, broadcast)

    def join(self, timeout: Optional[float] = None) -> List[Any]:
        """Join all threads; returns per-tid results."""
        return self.backend.join(self, timeout)

    def run(self, thread_proc: Callable, *, data: Sequence = (),
            broadcast: Sequence = (), timeout: Optional[float] = None) -> List[Any]:
        """``spawn`` + ``join``."""
        self.spawn(thread_proc, data=data, broadcast=broadcast)
        return self.join(timeout)

    def lower(self, thread_proc: Callable, *, data: Sequence = (),
              broadcast: Sequence = ()):
        """Trace + lower ``thread_proc`` — an SPMD-backend feature."""
        raise NotImplementedError(
            "Session.lower inspects the SPMD program; the SPMD backend is not "
            "ported yet (ROADMAP Queue 1 item 7)")

    def kill_node(self, node_id: int) -> List[int]:
        """Simulate a node failure; returns lost tids."""
        return self.backend.pool.kill_node(node_id)

    def healthy_nodes(self) -> List[int]:
        return self.backend.pool.healthy_nodes()

    def thread_states(self) -> Dict[int, Any]:
        return self.backend.pool.states()

    # -- Table 1: synchronization ---------------------------------------------

    def barrier(self, count: Optional[int] = None) -> DBarrier:
        """A counter barrier sized to the session's threads by default."""
        b = DBarrier(count or self.backend.n_threads)
        b.tracer = self.tracer
        return b

    def semaphore(self, count: int = 1) -> DSemaphore:
        s = DSemaphore(count)
        s.tracer = self.tracer
        return s

    def ssp_clock(self, staleness: int = 0, n_workers: Optional[int] = None) -> SSPClock:
        c = SSPClock(n_workers or self.backend.n_threads, staleness=staleness)
        c.tracer = self.tracer
        return c

    # -- accumulator registry / stats -----------------------------------------

    def accumulator(self, name: str, mode: Optional[AccumMode | str] = None):
        """The accumulator behind ``ref.accumulate``."""
        return self.backend.accumulator(self, name,
                                        AccumMode(mode) if mode else None)

    def wire_traffic(self) -> int:
        """Total accumulator wire traffic, in vector elements (paper §5.2)."""
        return self.backend.wire_traffic()

    def findings(self) -> List[Any]:
        raise NotImplementedError(
            "Session.findings needs step.check, which is not ported yet "
            "(ROADMAP Queue 1 item 8)")

    def watchdog(self, **kwargs):
        raise stepobs.not_ported("Session.watchdog")

    def openmetrics(self, *, prefix: str = "step", anomalies=None) -> str:
        raise stepobs.not_ported("Session.openmetrics")

    def stats(self) -> Dict[str, Any]:
        """Deprecated view: the original raw-counter triple; use
        :meth:`metrics`."""
        _warn_at_caller("Session.stats() is deprecated; use Session.metrics() "
                        "for the canonical normalized snapshot",
                        DeprecationWarning)
        legacy = ("get", "set", "inc", "bytes_get", "bytes_set",
                  "transfers", "migrated_in", "migrated_out")
        raw = self.store.stats
        return {"store": {k: raw.get(k, 0) for k in legacy},
                "cache": self.cache.stats,
                "wire_traffic": self.wire_traffic()}

    def metrics(self) -> Dict[str, Any]:
        """The unified observability snapshot, key set pinned by
        :data:`repro_torch.core.telemetry.SESSION_METRIC_KEYS`."""
        shard_rows = {
            sid: {"store": telemetry.normalize_store_stats(row["store"]),
                  "cache": row["cache"].as_dict(),
                  "wire_traffic": row["wire_traffic"]}
            for sid, row in self._shard_rows().items()}
        return {"backend": self.backend.kind,
                "store": telemetry.normalize_store_stats(self.store.stats),
                "cache": self.cache.stats.as_dict(),
                "wire_traffic": self.wire_traffic(),
                "shards": shard_rows,
                "tiers": {**self.store.tier_stats(),
                          "migration": self.store.migration_totals()},
                "trace": self.tracer.snapshot()}

    def shard_stats(self) -> Dict[int, Dict[str, Any]]:
        """Deprecated per-shard view; use ``metrics()['shards']``."""
        _warn_at_caller("Session.shard_stats() is deprecated; use "
                        "Session.metrics()['shards'] for the canonical "
                        "normalized per-shard rows", DeprecationWarning)
        return self._shard_rows()

    def _shard_rows(self) -> Dict[int, Dict[str, Any]]:
        cache_rows = self.cache.shard_stats()
        out: Dict[int, Dict[str, Any]] = {
            sid: {"store": row, "cache": cache_rows.get(sid, CacheStats()),
                  "wire_traffic": 0}
            for sid, row in self.store.shard_stats().items()}
        for (name, _, _), accu in self.backend._accumulators.items():
            sid = self.store.shard_of(name)
            if sid in out:
                out[sid]["wire_traffic"] += accu.bytes_transferred
        return out

    # -- ref-op dispatch (driver vs active worker ctx) ------------------------

    def _ctx(self):
        return getattr(self._tls, "ctx", None)

    def _read(self, name: str, owner=None):
        ctx = self._ctx()
        if ctx is None:
            return self.store.get(name, owner=owner)
        return ctx.read(name, owner=owner)

    def _write(self, name: str, value, owner=None) -> None:
        ctx = self._ctx()
        if ctx is None:
            self.store.set(name, value, owner=owner)
        else:
            ctx.write(name, value, owner=owner)

    def _inc(self, name: str, amount, owner=None):
        ctx = self._ctx()
        if ctx is None:
            return self.store.inc(name, amount, owner=owner)
        return ctx.inc(name, amount, owner=owner)

    def _accumulate(self, name: str, local, mode, k):
        ctx = self._ctx()
        if ctx is None:
            raise RuntimeError(
                "SharedRef.accumulate is a collective across the session's "
                "threads — call it inside a thread_proc run by Session.spawn")
        if k is None:
            k = self._sparse_k.get(name)  # the ref's declared default budget
        return ctx.accumulate(name, to_tensor(local, self.device),
                              AccumMode(mode) if mode is not None else self.accum_mode, k)

    # paper-cased aliases (Table 1)
    DefGlobal = def_global
    NewArray = new_array
    NewObj = new_object

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Session(backend={self.backend.kind}, device={self.device}, "
                f"threads={self.backend.n_threads}, names={self.names()})")
