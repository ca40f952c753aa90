"""Distributed thread synchronization — STEP §4.3/§5.3 (+ SSP for async).

The paper's master runs a *sync controller*: barriers are counters that
broadcast "release" when full; semaphores are counters with a FIFO wait queue.
Those semantics are reproduced exactly for the host-side thread pool (the
Pthreads-style programming model).  On the SPMD path a barrier is implicit in
every collective — `sync controller == the collective schedule` — so the SPMD
adapter simply documents the correspondence.

``SSPClock`` adds the bounded-staleness coordination STEP cites from Petuum:
workers may run up to `staleness` iterations ahead of the slowest worker —
this is the straggler-mitigation knob for the training path.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

from repro_torch.check import checker as stepcheck
from repro_torch.core import telemetry


class DBarrier:
    """Counter-based barrier with the paper's ``Enter(timeout)`` API.

    When a tracer is armed (``barrier.tracer``, attached by
    ``Session.barrier()`` and to the backend's run barrier), every ``enter``
    records a per-thread entry→release span (category ``barrier-wait``) and
    feeds the ``barrier.wait`` latency histogram.

    In-flight waits are tracked regardless of tracing (two dict ops under
    the condition lock per blocked enter): ``oldest_wait_start()`` is how
    the step.obs watchdog sees a straggler *while it is still waiting*, not
    only after the wait lands in the histogram."""

    watch_kind = "barrier"   # step.obs watchdog registry tag

    def __init__(self, count: int):
        self.count = count
        self._cond = threading.Condition()
        self._arrived = 0
        self._generation = 0
        self.entries = 0  # stats: total Enter calls observed by the controller
        self._wait_t0: Dict[int, float] = {}  # thread ident -> wait start
        self.tracer = telemetry.NULL_TRACER
        self.checker = stepcheck.NULL_CHECKER

    def enter(self, timeout: Optional[float] = None) -> bool:
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled:
            if ck.lint_sync(self, "barrier") is not None:
                return True          # lint dry run: recorded, never blocks
            ck.sync_block(self, "barrier")
            ok = False
            try:
                ok = self._enter_traced(timeout)
            finally:
                ck.sync_unblock(self, "barrier", ok)
            return ok
        return self._enter_traced(timeout)

    def _enter_traced(self, timeout: Optional[float] = None) -> bool:
        trc = self.tracer
        if telemetry.TRACING and trc.enabled:
            t0 = time.perf_counter()
            ok = self._enter(timeout)
            trc.wait_span("barrier-wait", "barrier.wait", t0, released=ok)
            return ok
        return self._enter(timeout)

    def _enter(self, timeout: Optional[float] = None) -> bool:
        with self._cond:
            gen = self._generation
            self._arrived += 1
            self.entries += 1
            if self._arrived == self.count:
                # last arrival: "release" broadcast
                self._arrived = 0
                self._generation += 1
                self._cond.notify_all()
                return True
            t = None if (timeout is None or timeout < 0) else timeout
            ident = threading.get_ident()
            self._wait_t0[ident] = time.perf_counter()
            try:
                while gen == self._generation:
                    if not self._cond.wait(timeout=t):
                        return False
                return True
            finally:
                self._wait_t0.pop(ident, None)

    def oldest_wait_start(self) -> Optional[float]:
        """``perf_counter`` timestamp of the longest-blocked in-flight enter
        (None when nobody is waiting) — the watchdog's live-stall probe."""
        with self._cond:
            return min(self._wait_t0.values(), default=None)

    def waiters(self) -> int:
        with self._cond:
            return len(self._wait_t0)

    # paper-cased alias (Enter(int timeout=-1))
    def Enter(self, timeout: float = -1) -> bool:
        return self.enter(None if timeout is None or timeout < 0 else timeout)


class DSemaphore:
    """Counting semaphore with FIFO wakeup, as specified in §5.3.

    Like :class:`DBarrier`, in-flight acquire waits are tracked always
    (``oldest_wait_start()``), so the watchdog can flag a starved acquirer
    before its wait ever completes into the latency histogram."""

    watch_kind = "semaphore"   # step.obs watchdog registry tag

    def __init__(self, count: int):
        if count < 0:
            raise ValueError("semaphore count must be non-negative")
        self._count = count
        self._cond = threading.Condition()
        self._queue: deque[int] = deque()
        self._ticket = 0
        self._wait_t0: Dict[int, float] = {}  # ticket -> wait start
        self.tracer = telemetry.NULL_TRACER
        self.checker = stepcheck.NULL_CHECKER

    def acquire(self, timeout: Optional[float] = None) -> bool:
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled:
            if ck.lint_sync(self, "semaphore") is not None:
                return True          # lint dry run: recorded, never blocks
            ck.sync_block(self, "semaphore")
            ok = False
            try:
                ok = self._acquire_traced(timeout)
            finally:
                ck.sync_unblock(self, "semaphore", ok)
            return ok
        return self._acquire_traced(timeout)

    def _acquire_traced(self, timeout: Optional[float] = None) -> bool:
        trc = self.tracer
        if telemetry.TRACING and trc.enabled:
            t0 = time.perf_counter()
            ok = self._acquire(timeout)
            trc.wait_span("sync", "semaphore.acquire", t0, acquired=ok)
            return ok
        return self._acquire(timeout)

    def _acquire(self, timeout: Optional[float] = None) -> bool:
        trc = self.tracer
        with self._cond:
            ticket = self._ticket
            self._ticket += 1
            self._queue.append(ticket)
            self._wait_t0[ticket] = time.perf_counter()
            if telemetry.TRACING and trc.enabled:
                trc.observe("semaphore.queue_depth", float(len(self._queue)))
            t = None if (timeout is None or timeout < 0) else timeout
            try:
                while not (self._count > 0 and self._queue[0] == ticket):
                    if not self._cond.wait(timeout=t):
                        self._queue.remove(ticket)
                        return False
                self._queue.popleft()
                self._count -= 1
                self._cond.notify_all()
                return True
            finally:
                self._wait_t0.pop(ticket, None)

    def oldest_wait_start(self) -> Optional[float]:
        """``perf_counter`` timestamp of the head-of-queue (longest) in-flight
        acquire, or None when the queue is idle."""
        with self._cond:
            return min(self._wait_t0.values(), default=None)

    def waiters(self) -> int:
        with self._cond:
            return len(self._wait_t0)

    def release(self) -> None:
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled:
            if ck.lint_sync(self, "semaphore") is not None:
                return               # lint dry run: recorded, never mutates
            ck.sem_release(self)     # publish the hand-off edge pre-release
        with self._cond:
            self._count += 1
            self._cond.notify_all()

    # paper-cased aliases
    def Acquire(self, timeout: float = -1) -> bool:
        return self.acquire(None if timeout is None or timeout < 0 else timeout)

    Release = release


class SSPClock:
    """Stale Synchronous Parallel clock (Petuum-style, cited by the paper).

    ``tick(tid)`` advances a worker's clock; ``wait(tid)`` blocks while the
    worker is more than ``staleness`` ticks ahead of the slowest worker.
    ``staleness=0`` degenerates to a barrier (fully synchronous).
    """

    def __init__(self, n_workers: int, staleness: int = 0):
        self.staleness = staleness
        self._clocks: Dict[int, int] = {i: 0 for i in range(n_workers)}
        self._cond = threading.Condition()
        self.block_events = 0
        self.tracer = telemetry.NULL_TRACER
        self.checker = stepcheck.NULL_CHECKER

    def tick(self, tid: int) -> int:
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled:
            if ck.lint_sync(self, "ssp") is not None:
                return self._clocks.get(tid, 0) + 1   # dry run: no mutation
            ck.ssp_tick(self)        # publish the window edge pre-tick
        with self._cond:
            self._clocks[tid] += 1
            self._cond.notify_all()
            return self._clocks[tid]

    def wait(self, tid: int, timeout: Optional[float] = None) -> bool:
        ck = self.checker
        if stepcheck.CHECKING and ck.enabled:
            if ck.lint_sync(self, "ssp") is not None:
                return True          # lint dry run: recorded, never blocks
            ok = self._wait(tid, timeout)
            ck.ssp_wait_done(self, ok)
            return ok
        return self._wait(tid, timeout)

    def _wait(self, tid: int, timeout: Optional[float] = None) -> bool:
        trc = self.tracer
        tracing = telemetry.TRACING and trc.enabled
        t0 = time.perf_counter() if tracing else 0.0
        stalled = False
        with self._cond:
            if tracing:
                trc.observe(
                    "ssp.skew",
                    float(self._clocks[tid] - min(self._clocks.values())))
            while self._clocks[tid] - min(self._clocks.values()) > self.staleness:
                self.block_events += 1
                stalled = True
                if not self._cond.wait(timeout=timeout):
                    if tracing:
                        trc.wait_span("sync", "ssp.stall", t0,
                                      tid=tid, released=False)
                    return False
        if tracing and stalled:
            trc.wait_span("sync", "ssp.stall", t0, tid=tid, released=True)
        return True

    def min_clock(self) -> int:
        with self._cond:
            return min(self._clocks.values())

    def drop_worker(self, tid: int) -> None:
        """Remove a failed worker so survivors are not blocked forever (FT)."""
        with self._cond:
            self._clocks.pop(tid, None)
            self._cond.notify_all()

    def add_worker(self, tid: int, clock: Optional[int] = None) -> None:
        with self._cond:
            self._clocks[tid] = self.min_clock() if clock is None else clock
            self._cond.notify_all()
