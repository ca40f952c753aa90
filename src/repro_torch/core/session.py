"""step.Session — the paper's Table 1 as ONE facade over DSM, threads and sync.

Port of :mod:`repro.core.session`.  A :class:`Session` owns the
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

and runs unchanged on either substrate, selected at construction:

* ``backend="host"`` — :class:`HostBackend`: the paper's programming model.
  ``DThreadPool`` threads, blocking ``DAddAccumulator`` rounds, reads served
  through the write-invalidate DSM cache, barrier-based release.
* ``backend="spmd"`` — :class:`SpmdBackend`: one STEP thread per position of
  a mesh (:mod:`repro_torch.core.compat`), each a Python thread on the
  session's device.  ``SharedRef.accumulate`` becomes the SPMD collective
  (reduce-scatter / all-gather, sparse pairs), ``SharedRef.get``/``set``
  touch the position's own copy of the shared values, and barriers are
  implicit in the collectives.  Where the JAX package traces the program
  once and runs it over the mesh, here each position runs ``thread_proc``
  itself; the traffic accounting is charged by position 0 alone, so it
  comes out once per collective, as the JAX package's trace-time accounting
  does.  Its ``spmd.trace`` span has no counterpart (nothing is traced),
  and ``lower()`` is a non-goal of the port (ROADMAP Queue 1 item 7).

``check=True`` arms step.check (:mod:`repro_torch.check`) and
``record=True`` step.obs's flight recorder (:mod:`repro_torch.obs`); both
work on either backend, and the race detector sees the driver's and the host
workers' accesses (never an SPMD position's, as in the JAX package).

Everything a session holds lives on its ``device``: ``device=None`` is the
card (see :func:`~repro_torch.device.resolve_device`), and ``spawn`` moves
``data=`` and ``broadcast=`` there once, so the dataset lives on the card.

The bulk-synchronous contract: within ``thread_proc``, ``ref.set(v)`` must be
called with a value that is identical across threads (all threads re-derive
the update from the accumulated total).
"""

from __future__ import annotations

import math
import threading
import time
import warnings
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch import obs as stepobs
from repro_torch.check import checker as stepcheck
from repro_torch.core import telemetry
from repro_torch.core.accumulator import AccumMode, DAddAccumulator
from repro_torch.core.accumulator import accumulate as spmd_accumulate
from repro_torch.core.cache import CacheStats, DSMCache
from repro_torch.core.compat import Mesh, make_mesh, psum, run_positions
from repro_torch.core.dsm import GlobalStore
from repro_torch.core.sparse import default_auto_k, pair_capacity
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

    def count(self, name: str, amount: float = 1) -> None:
        """Add ``amount`` to the session tracer's counter ``name`` where it
        is armed: the apps' per-thread counts, exact under concurrent
        threads."""
        trc = self._session.tracer
        if telemetry.TRACING and trc.enabled:
            trc.count_exact(name, amount)

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
        return self._session.span("app-round", name, **args)

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


def _on_device(value, device: torch.device):
    """A value to write into a position's shared values: a tensor on the
    session's device, or a dict of them for a shared object."""
    if isinstance(value, dict):
        return {f: to_tensor(v, device) for f, v in value.items()}
    return to_tensor(value, device)


class SpmdWorkerCtx(WorkerCtx):
    """One mesh position's view: its own copy of the shared values, taken
    from the store at spawn; barriers are the collectives themselves.

    Position 0 of the mesh is the *leader*: it alone charges the backend's
    traffic and counts the ``spmd.*`` telemetry, so both come out once per
    collective call, not once per position."""

    def __init__(self, session: "Session", backend: "SpmdBackend", tid: int,
                 values: Dict[str, Any], leader: bool, on_axis: bool):
        super().__init__(session, tid, backend.n_threads, tid)
        self._backend = backend
        self.values = values
        self._leader = leader
        self._on_axis = on_axis  # the position whose result stands for its tid
        self._accum_repeat = 1   # the enclosing loops' trip counts, multiplied
        self._first_trip = True  # in the first trip of every enclosing loop

    # -- iteration: a Python loop with the JAX package's scan accounting -----

    def fori(self, step: Callable, carry, iters: int):
        iters = int(iters)
        if iters <= 0:
            return carry
        trc = self._session.tracer
        if self._leader and self._first_trip and telemetry.TRACING and trc.enabled:
            # the JAX package counts a scan site once, when it traces it, and
            # its trips as iters times the enclosing loops' trips
            trc.count("spmd.scan_sites")
            trc.count("spmd.scan_trips", iters * self._accum_repeat)
        outer_repeat, outer_first = self._accum_repeat, self._first_trip
        self._accum_repeat = outer_repeat * iters
        try:
            for i in range(iters):
                self._first_trip = outer_first and i == 0
                carry = step(i, carry)
        finally:
            self._accum_repeat, self._first_trip = outer_repeat, outer_first
        return carry

    def count(self, name: str, amount: float = 1) -> None:
        """Counted once per thread: by the positions on the data axis (the
        positions off it repeat a thread's work)."""
        if self._on_axis:
            super().count(name, amount)

    # -- ref-op routing (the position's own values: `owner` has no transport
    # to shortcut and is ignored) --------------------------------------------

    def read(self, name: str, owner=None):
        return self.values[name]

    def write(self, name: str, value, owner=None) -> None:
        self.values[name] = _on_device(value, self.device)

    def inc(self, name: str, amount, owner=None):
        # `Inc` is per-thread: N positions calling inc(a) advance the value
        # by N·a, exactly as N atomic increments do on the host backend
        total = psum(to_tensor(amount, self.device), self._backend.axis)
        self.values[name] = self.values[name] + total
        return self.values[name]

    def accumulate(self, name: str, local, mode: AccumMode, k: Optional[int]):
        vec = local if local.ndim else local[None]   # collectives want rank>=1
        shard = self._session.store.shard_of(name)
        took_sparse = False
        if mode == AccumMode.AUTO:
            total, took_sparse = spmd_accumulate(vec, self._backend.axis, mode,
                                                 k=k, with_branch=True,
                                                 tracer=self._session.tracer)
        else:
            total = spmd_accumulate(vec, self._backend.axis, mode, k=k)
        if not local.ndim:
            total = total[0]
        self.values[name] = total
        if self._leader:
            self._backend.stats.account(mode, self.n_threads, int(local.numel()), k,
                                        shard=shard, took_sparse=took_sparse)
        return total


def _warn_at_caller(message: str, category) -> None:
    """Warn with the first stack frame *outside this module* as the location."""
    import sys
    level, frame = 2, sys._getframe(1)
    while frame is not None and frame.f_globals.get("__name__") == __name__:
        frame = frame.f_back
        level += 1
    warnings.warn(message, category, stacklevel=level)


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


@runtime_checkable
class Backend(Protocol):
    """Execution substrate behind a Session: place threads, run them, account
    accumulator traffic.  Everything the facade asks of a backend is here; two
    implementations ship: :class:`HostBackend` and :class:`SpmdBackend`."""

    kind: str

    @property
    def device(self) -> Optional[torch.device]:
        """The device the backend is fixed to, or None (the session's)."""

    @property
    def n_threads(self) -> int: ...

    @property
    def n_nodes(self) -> int: ...

    def bind(self, session: "Session") -> None:
        """Attach to a session whose store, device and tracer are set."""

    def spawn(self, session: "Session", thread_proc: Callable,
              data: Sequence, broadcast: Sequence) -> None: ...

    def join(self, session: "Session", timeout: Optional[float]) -> List[Any]: ...

    def accumulator(self, session: "Session", name: str,
                    mode: Optional[AccumMode] = None, k: Optional[int] = None): ...

    def kill_node(self, node_id: int) -> List[int]: ...

    def healthy_nodes(self) -> List[int]: ...

    def states(self) -> Dict[int, Any]: ...

    def wire_traffic(self) -> int: ...

    def shard_wire(self, store: GlobalStore) -> Dict[int, int]:
        """Accumulator wire traffic by the shard owning each output ref."""


class HostBackend:
    """The paper-faithful path: DThreadPool + blocking DAddAccumulator."""

    kind = "host"
    device = None   # runs wherever the session's store lives

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

    def bind(self, session: "Session") -> None:
        self.run_barrier.tracer = session.tracer
        self.run_barrier.checker = session.checker
        session._watch_prims.add(self.run_barrier)

    def kill_node(self, node_id: int) -> List[int]:
        return self.pool.kill_node(node_id)

    def healthy_nodes(self) -> List[int]:
        return self.pool.healthy_nodes()

    def states(self) -> Dict[int, Any]:
        return self.pool.states()

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
                                       tracer=session.tracer,
                                       checker=session.checker)
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
            ck = session.checker
            if stepcheck.CHECKING and ck.enabled:
                # the worker's vector clock starts from the driver's spawn
                # snapshot (the spawn happens-before edge)
                ck.bind_thread(tid, ctx.node_id)
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

    def shard_wire(self, store: GlobalStore) -> Dict[int, int]:
        out: Dict[int, int] = {}
        with self._lock:
            for (name, _, _), accu in self._accumulators.items():
                sid = store.shard_of(name)
                out[sid] = out.get(sid, 0) + accu.bytes_transferred
        return out


@dataclass
class SpmdTraffic:
    """Per-call traffic accounting for the SPMD accumulator, mirroring the
    host accumulator's cost model, charged once per collective call (by the
    mesh's leader position).  ``sparse`` is costed at its top-k budget;
    ``auto`` at the branch the round took — the figure the JAX package
    reaches by settling its trace-time dense bound at ``join``.

    ``by_shard`` attributes each call's traffic to the shard owning the
    output ref — the per-shard half of ``Session.shard_stats()``."""

    bytes_transferred: int = 0
    rounds: int = 0
    by_shard: Dict[int, int] = field(default_factory=dict)

    def account(self, mode: AccumMode, n: int, vec_len: int, k: Optional[int],
                *, shard: Optional[int] = None, took_sparse: bool = False) -> None:
        """Charge one round of an accumulate call.  ``vec_len`` is the total
        element count of the local contribution (scalars cost 1, like the
        host accumulator).

        ``sparse`` ships ``pair_capacity(V, k)`` static (index, value) pairs
        from each of the ``n`` positions and republishes ``V`` — the same
        ``Σ 2·pairs + V`` as the host accumulator; ``auto`` with
        ``took_sparse`` costs the same at its (default) budget, otherwise
        the dense ``(n+1)·V``."""
        if mode == AccumMode.AUTO and took_sparse:
            k = k if k is not None else default_auto_k(vec_len)
            mode = AccumMode.SPARSE
        if mode == AccumMode.GATHER_ALL:
            per_round = (2 * n + 1) * vec_len
        elif mode == AccumMode.SPARSE:
            per_round = 2 * pair_capacity(vec_len, k) * n + vec_len
        else:  # REDUCE_SCATTER / HIERARCHICAL / AUTO's dense branch
            per_round = (n + 1) * vec_len
        self.bytes_transferred += per_round
        if shard is not None:
            self.by_shard[shard] = self.by_shard.get(shard, 0) + per_round
        self.rounds += 1


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class SpmdBackend:
    """One STEP thread per mesh position, each a Python thread on the
    session's device (:func:`~repro_torch.core.compat.run_positions`).

    ``spawn`` records the program; ``join`` runs it, one position per
    thread, then writes position 0's shared values back into the session's
    store so the driver-side ``ref.get()`` sees the result exactly as it
    does on the host backend.  Rows of ``data=`` split evenly over the
    ``axis`` (ragged rows are dropped, with a warning); every ``broadcast=``
    array goes whole to each position.  ``mesh=None`` is one position per
    visible device of the session's device type (one on the CPU), fixed
    when the session binds the backend.
    """

    kind = "spmd"

    def __init__(self, mesh: Optional[Mesh] = None, axis: str = "data"):
        if mesh is not None and axis not in mesh.axis_names:
            raise ValueError(f"mesh has axes {mesh.axis_names}, no {axis!r}")
        self.mesh = mesh
        self.axis = axis
        self.stats = SpmdTraffic()
        self._pending = None

    @property
    def device(self) -> Optional[torch.device]:
        return None if self.mesh is None else self.mesh.device

    def bind(self, session: "Session") -> None:
        """Fix the mesh on the session's device."""
        device = session.device
        if self.mesh is None:
            count = torch.cuda.device_count() if device.type == "cuda" else 1
            self.mesh = make_mesh((count,), (self.axis,), device)
        elif self.mesh.device is not None and not _same_device(self.mesh.device, device):
            raise ValueError(f"the mesh is on {self.mesh.device}, the session on {device}")

    def _mesh(self) -> Mesh:
        if self.mesh is None:
            raise RuntimeError("SpmdBackend(mesh=None) has no mesh until a Session binds it")
        return self.mesh

    @property
    def n_threads(self) -> int:
        return int(self._mesh().shape[self.axis])

    @property
    def n_nodes(self) -> int:
        return self.n_threads

    def kill_node(self, node_id: int) -> List[int]:
        raise RuntimeError("node-failure simulation needs the host backend")

    def healthy_nodes(self) -> List[int]:
        return list(range(self.n_nodes))

    def states(self) -> Dict[int, Any]:
        return {}

    def accumulator(self, session: "Session", name: str,
                    mode: Optional[AccumMode] = None,
                    k: Optional[int] = None) -> SpmdTraffic:
        """The traffic stats: every ref's collectives share them."""
        return self.stats

    def spawn(self, session: "Session", thread_proc: Callable,
              data: Sequence, broadcast: Sequence) -> None:
        if self._pending is not None:
            raise RuntimeError("SPMD backend already has a spawned program; join() it first")
        self._pending = (thread_proc, tuple(data), tuple(broadcast))

    def join(self, session: "Session", timeout: Optional[float] = None) -> List[Any]:
        if self._pending is None:
            return []
        thread_proc, data, broadcast = self._pending
        self._pending = None
        mesh, axis, n = self._mesh(), self.axis, self.n_threads
        trc = session.tracer
        tracing = telemetry.TRACING and trc.enabled
        wire_before = self.stats.bytes_transferred
        t0 = time.perf_counter() if tracing else 0.0
        # an even split: trim ragged rows (the host backend gives the
        # remainder to low tids instead; parity holds whenever n divides rows)
        dropped = [int(a.shape[0] % n) for a in data]
        if any(dropped):
            _warn_at_caller(
                f"SpmdBackend: dropping {sum(dropped)} ragged row(s) "
                f"({dropped} per data array) so shard_map splits "
                f"evenly across {n} threads; pad or trim row counts to a "
                "multiple of n_threads for host/SPMD parity",
                UserWarning)
        data = tuple(a[: (a.shape[0] // n) * n] for a in data)
        names = session.store.names()
        shared0 = {m: session.store.get(m) for m in names}
        rows = [a.shape[0] // n for a in data]

        def on_axis(linear: int) -> bool:
            return all(c == 0 for a, c in mesh.coords(linear).items() if a != axis)

        def position(linear: int):
            tid = mesh.coords(linear)[axis]
            shards = [a[tid * r:(tid + 1) * r] for a, r in zip(data, rows)]
            ctx = SpmdWorkerCtx(session, self, tid, dict(shared0), linear == 0,
                                on_axis(linear))
            session._tls.ctx = ctx
            try:
                return thread_proc(ctx, *shards, *broadcast), ctx.values
            finally:
                session._tls.ctx = None

        outs = run_positions(mesh, position, timeout)
        for m in names:
            session.store.set(m, outs[0][1][m])
        # one result per position of the axis, in tid order (the positions
        # off the axis repeat them)
        out = [res for i, (res, _) in enumerate(outs) if on_axis(i)]
        if tracing:
            trc.add_span("spmd", "spmd.execute", t0, time.perf_counter(),
                         {"threads": n})
            trc.count("spmd.joins")
            trc.count("spmd.collective_elements",
                      self.stats.bytes_transferred - wire_before)
        return out

    def wire_traffic(self) -> int:
        return self.stats.bytes_transferred

    def shard_wire(self, store: GlobalStore) -> Dict[int, int]:
        return dict(self.stats.by_shard)


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------


class Session:
    """Table 1 as one object: DSM + cluster/thread management + sync.

    Parameters
    ----------
    backend:
        ``"host"`` | ``"spmd"`` | a :class:`Backend` instance.
    n_nodes / threads_per_node:
        Host-backend cluster shape (ignored for SPMD).
    mesh / axis:
        SPMD mesh (:func:`~repro_torch.core.compat.make_mesh`; defaults to
        one position per visible device of the session's device type) and
        the axis its threads run along.
    device:
        Where shared data and spawned datasets live; ``None`` is the card,
        and raises on a host without a visible GPU.  An adopted store's
        device, or else an SPMD mesh's, wins when ``device`` is None.
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
    check:
        step.check arming, the same contract: ``True`` arms a fresh
        :class:`~repro_torch.check.Checker` (happens-before race detection,
        lock-order sanitizing, and a spawn-time lint that rejects
        structurally broken programs with
        :class:`~repro_torch.check.CheckError`), a checker is adopted as-is,
        and ``None`` leaves checking off at one-branch hot-path cost.
        Inspect via ``session.checker`` / :meth:`findings`.  A caller that
        arms one calls ``session.checker.disable()`` when done.
    record:
        step.obs flight-recorder arming, the same contract again: ``True``
        arms a fresh :class:`~repro_torch.obs.FlightRecorder` (a bounded ring
        of recent events; the tracer runs *record-only* unless ``trace``
        armed it fully), a recorder is adopted as-is, ``None`` leaves
        recording off.  Pair with :meth:`watchdog` and :meth:`openmetrics`;
        call ``session.recorder.close()`` when done.
    cold_tier / cold_budget:
        step.tiers for a freshly built store (ignored when adopting
        ``store``, whose tiering FT recovery keeps as is): ``cold_tier`` is
        ``None`` (one tier, on the device), ``"host"`` (CPU tensors),
        ``"disk"`` (pickled spill files in a temporary directory) or a
        :class:`~repro_torch.core.tiers.ColdTier`; ``cold_budget`` caps each
        shard's hot bytes, past which LRU entries demote to the cold tier
        and promote back (epoch kept) on access.
    """

    def __init__(self, backend: Backend | str = "host", *,
                 n_nodes: int = 2, threads_per_node: int = 2,
                 mesh: Optional[Mesh] = None, axis: str = "data",
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
                backend = SpmdBackend(mesh=mesh, axis=axis)
            else:
                raise ValueError(f"backend must be host|spmd, got {backend!r}")
        self.backend = backend
        self.checker = stepcheck.as_checker(check)
        self.recorder = stepobs.as_recorder(record)
        self.tracer = telemetry.as_tracer(trace)
        self.recorder.attach(self.tracer)
        # sync primitives handed out by this session, for the watchdog's
        # scan of in-flight waits (weak: a dropped barrier unregisters itself)
        self._watch_prims: "weakref.WeakSet" = weakref.WeakSet()
        if store is not None:
            if device is not None and resolve_device(device) != store.device:
                raise ValueError(f"device {device} differs from the adopted "
                                 f"store's {store.device}")
            self.store = store
        else:
            self.store = GlobalStore(device if device is not None else backend.device,
                                     granularity=granularity, shards=shards,
                                     cold_tier=cold_tier, cold_budget=cold_budget)
        self.device = self.store.device
        backend.bind(self)
        self.store.tracer = self.tracer
        self.store.checker = self.checker
        self.accum_mode = AccumMode(accum_mode)
        self.cache = DSMCache(self.store, n_nodes=backend.n_nodes,
                              capacity=cache_capacity)
        self.cache.tracer = self.tracer
        self.cache.checker = self.checker
        self._sparse_k: Dict[str, int] = {}  # per-ref default top-k budgets
        self._tls = threading.local()

    # -- Table 1: DSM manipulation --------------------------------------------

    def def_global(self, name: str, value, *,
                   sparse_k: Optional[int] = None) -> SharedRef:
        """``DefGlobal`` — declare + initialise a shared variable.
        ``sparse_k`` sets the ref's default top-k budget for sparse/auto
        accumulates."""
        self.store.def_global(name, value)
        self._set_sparse_k(name, sparse_k,
                           size=None if sparse_k is None
                           else value.numel() if isinstance(value, torch.Tensor)
                           else math.prod(np.shape(value)))
        return SharedRef(self, name)

    def new_array(self, name: str, shape, dtype=torch.float32, *,
                  sparse_k: Optional[int] = None) -> SharedRef:
        """``NewArray`` — allocate a zeroed shared array.  ``sparse_k`` is the
        ref's default top-k budget for sparse/auto accumulates."""
        self.store.new_array(name, shape, dtype)
        self._set_sparse_k(name, sparse_k,
                           size=None if sparse_k is None
                           else int(np.prod(shape, dtype=np.int64)) if shape else 1)
        return SharedRef(self, name)

    def _set_sparse_k(self, name: str, sparse_k: Optional[int],
                      size: Optional[int] = None) -> None:
        self._sparse_k.pop(name, None)  # re-declared names drop the old budget
        if sparse_k is not None:
            if sparse_k < 1:
                raise ValueError(f"sparse_k must be >= 1, got {sparse_k}")
            self._sparse_k[name] = int(sparse_k)
            ck = self.checker
            if stepcheck.CHECKING and ck.enabled and size is not None:
                # declaration-time lint: a budget the blocked pair layout
                # cannot ship is silently lossier than asked
                ck.lint_sparse_budget(name, int(size), int(sparse_k))

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
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled:
            # advisory directory peek (no lock): a delete while nodes still
            # hold replicas is legal but worth a lint warning — a concurrent
            # reader of the deleted era may be mid-flight
            holders = set(self.store.shard_for(name).directory.get(name, ()))
            if holders:
                ck.check_delete(name, holders)
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
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled:
            # lint dry run first: a strict checker raises CheckError here, so
            # a structurally broken program is rejected before any thread
            # (or mesh position) exists
            ck.lint_spawn(self, thread_proc, data, broadcast)
            ck.on_spawn(self.backend.n_threads)
        self.backend.spawn(self, thread_proc, data, broadcast)

    def span(self, cat: str, name: str, **args):
        """A span of category ``cat`` on the calling thread's timeline while
        the session's tracer is armed, else the shared no-op span.  On a
        thread ``torch.profiler`` records, it is also a profiler range of the
        same name (:mod:`~repro_torch.core.telemetry`)."""
        return telemetry.guarded_span(self.tracer, cat, name, **args)

    def join(self, timeout: Optional[float] = None) -> List[Any]:
        """Join all threads; returns per-tid results."""
        try:
            return self.backend.join(self, timeout)
        finally:
            ck = self.checker
            if stepcheck.CHECKING and ck.enabled:
                # the join happens-before edge: the driver's clock absorbs
                # every worker's; the lock sanitizer's wait-for state resets
                ck.after_join()

    def run(self, thread_proc: Callable, *, data: Sequence = (),
            broadcast: Sequence = (), timeout: Optional[float] = None) -> List[Any]:
        """``spawn`` + ``join``."""
        self.spawn(thread_proc, data=data, broadcast=broadcast)
        return self.join(timeout)

    def lower(self, thread_proc: Callable, *, data: Sequence = (),
              broadcast: Sequence = ()):
        """Trace + lower ``thread_proc`` — XLA's program, which the port's
        in-process mesh never builds."""
        raise NotImplementedError(
            "Session.lower inspects an XLA-lowered program; the port's mesh "
            "traces nothing, a non-goal recorded in ROADMAP Queue 1 item 7")

    def kill_node(self, node_id: int) -> List[int]:
        """Simulate a node failure (host backend); returns lost tids."""
        return self.backend.kill_node(node_id)

    def healthy_nodes(self) -> List[int]:
        return self.backend.healthy_nodes()

    def thread_states(self) -> Dict[int, Any]:
        return self.backend.states()

    # -- Table 1: synchronization ---------------------------------------------

    def barrier(self, count: Optional[int] = None) -> DBarrier:
        """A counter barrier sized to the session's threads by default."""
        b = DBarrier(count or self.backend.n_threads)
        b.tracer = self.tracer
        b.checker = self.checker
        self._watch_prims.add(b)
        return b

    def semaphore(self, count: int = 1) -> DSemaphore:
        s = DSemaphore(count)
        s.tracer = self.tracer
        s.checker = self.checker
        self._watch_prims.add(s)
        return s

    def ssp_clock(self, staleness: int = 0, n_workers: Optional[int] = None) -> SSPClock:
        c = SSPClock(n_workers or self.backend.n_threads, staleness=staleness)
        c.tracer = self.tracer
        c.checker = self.checker
        return c

    # -- accumulator registry / stats -----------------------------------------

    def accumulator(self, name: str, mode: Optional[AccumMode | str] = None):
        """The accumulator behind ``ref.accumulate`` (host backend; the SPMD
        backend's traffic stats otherwise)."""
        return self.backend.accumulator(self, name,
                                        AccumMode(mode) if mode else None)

    def wire_traffic(self) -> int:
        """Total accumulator wire traffic, in vector elements (paper §5.2)."""
        return self.backend.wire_traffic()

    def findings(self) -> List[Any]:
        """Findings recorded by this session's checker (see step.check):
        race/lock/lint :class:`~repro_torch.check.Finding` rows.  Empty unless
        the session was built with ``check=True`` (or an armed checker)."""
        return self.checker.findings()

    def watchdog(self, **kwargs) -> "stepobs.Watchdog":
        """A :class:`~repro_torch.obs.Watchdog` over this session, not
        started: call ``.start()`` for the daemon thread or drive
        ``poll_once()``.  Each anomaly carries a flight-recorder dump when
        :attr:`recorder` is armed."""
        return stepobs.Watchdog(self, **kwargs)

    def openmetrics(self, *, prefix: str = "step",
                    anomalies: Optional[Sequence[Any]] = None) -> str:
        """:meth:`metrics` as OpenMetrics / Prometheus exposition text.  Pass
        ``watchdog.anomalies`` to add the anomaly counters to the page."""
        return stepobs.openmetrics(self.metrics(), prefix=prefix,
                                   anomalies=anomalies)

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
        for sid, elems in self.backend.shard_wire(self.store).items():
            if sid in out:
                out[sid]["wire_traffic"] += elems
        return out

    # -- ref-op dispatch (driver vs active worker ctx) ------------------------

    def _ctx(self):
        return getattr(self._tls, "ctx", None)

    def _read(self, name: str, owner=None):
        ctx = self._ctx()
        value = (self.store.get(name, owner=owner) if ctx is None
                 else ctx.read(name, owner=owner))
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled and (
                ctx is None or type(ctx) is HostWorkerCtx):
            # race detection sees host/driver accesses only, as in the JAX
            # package: an SPMD position's refs are its own copies (ordered by
            # the collective schedule, though here they are real threads)
            # and the lint dry run's shadow ctx must stay invisible
            ck.on_access(name, "read", value)
        return value

    def _write(self, name: str, value, owner=None) -> None:
        ctx = self._ctx()
        if ctx is None:
            self.store.set(name, value, owner=owner)
        else:
            ctx.write(name, value, owner=owner)
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled and (
                ctx is None or type(ctx) is HostWorkerCtx):
            ck.on_access(name, "write", value)

    def _inc(self, name: str, amount, owner=None):
        ctx = self._ctx()
        result = (self.store.inc(name, amount, owner=owner) if ctx is None
                  else ctx.inc(name, amount, owner=owner))
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled and (
                ctx is None or type(ctx) is HostWorkerCtx):
            # inc is atomic under the owning shard's lock: inc-inc pairs
            # commute and are never racy; inc vs set/get still is
            ck.on_access(name, "inc", result)
        return result

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


def deprecated_entry(old: str, new: str) -> None:
    """One-liner for the pre-Session entry points kept as shims."""
    warnings.warn(f"{old} is deprecated; use {new}", DeprecationWarning,
                  stacklevel=3)
