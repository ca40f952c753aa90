"""Happens-before race detection for the host backend (step.check layer 1;
port of :mod:`repro.check.races`).

Classic vector-clock analysis, FastTrack-style: every STEP thread (plus the
driver) carries a vector clock; synchronization primitives add edges by
publishing the sender's clock into a per-object *pending* clock and joining
it into the receiver's.  The edges modelled:

* **spawn / join** — workers start from the driver's clock at ``spawn``; the
  driver joins every worker's clock at ``join``.
* **DBarrier release** — every ``enter`` publishes before blocking and joins
  the merged pending clock on release, so accesses before the barrier order
  against accesses after it in *every* thread.
* **DSemaphore hand-off** — ``release`` publishes, a successful ``acquire``
  joins (the critical-section transfer edge).
* **SSPClock window** — ``tick`` publishes, a successful ``wait`` joins the
  merged ticks.  This over-approximates the bounded-staleness ordering
  (deliberately: step.check must not false-positive on the sync the user
  *does* have; truly unsynchronized accesses still have no edge at all).
* **accumulator round** — each thread publishes at the top of ``accumulate``
  and joins when the round barrier releases; the collective store write is
  recorded at each thread's publish-time clock, which every peer dominates
  after the join.

Per DSM name, the last write and last read *per thread* are kept (program
order makes earlier accesses redundant).  An access pair is racy when neither
clock dominates the other.

One refinement keeps the paper's §4.5 idiom clean: the session's
bulk-synchronous contract says an in-worker ``ref.set(v)`` passes a value
identical across threads (every thread re-derives the same update from the
accumulated total).  A candidate pair whose values compare equal is therefore
counted as a *benign replicated write* instead of a race — an unordered pair
carrying identical bits cannot change any observable value.  A *read* racing
such a write earns the exemption only when the reading thread holds its own
program-ordered copy of the same bits (it participated in the replicated
set); otherwise observing the "right" value is luck, not safety.  Accesses
with differing values (the actual bug class) are always reported.

The read's exemption holds in whichever order the pair reaches the detector.
A session records an access after its store op, outside any lock they share,
so a read can observe a write's bits and still be recorded first.  When the
write is recorded later, it is excused against that read only under the same
condition: the reader held its own copy of those bits when it read.
``repro.check.races`` excuses any equal-valued read there, so it misses the
race in that interleaving (ROADMAP, Queue 3).

The port snapshots torch values (:func:`snapshot_value`): a ``detach().clone()``
of every tensor leaf, kept on the value's own device.  A clone, because the
store hands out the stored tensor itself and a snapshot that kept a reference
would change under a later in-place write; torch and not numpy, because numpy
holds no bf16 and a D2H copy of a large shared vector on every access is the
cost to avoid.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

DRIVER = "driver"


def _leaves(value) -> list:
    """A value's leaves in the JAX package's tree order: a dict's by sorted
    key, a list's or tuple's in order, ``None`` has none."""
    if value is None:
        return []
    if isinstance(value, dict):
        return [leaf for k in sorted(value) for leaf in _leaves(value[k])]
    if isinstance(value, (list, tuple)):
        return [leaf for v in value for leaf in _leaves(v)]
    return [value]


def snapshot_value(value) -> Tuple[torch.Tensor, ...]:
    """A private copy of a value's leaves, for the replicated-write
    comparison: each tensor cloned on its own device, anything else (a Python
    or numpy scalar or array) taken as ``np.asarray`` takes it."""
    return tuple(leaf.detach().clone() if isinstance(leaf, torch.Tensor)
                 else torch.as_tensor(np.asarray(leaf))
                 for leaf in _leaves(value))


def values_equal(a, b) -> bool:
    if a is None or b is None:
        return False
    if len(a) != len(b):
        return False
    return all(x.shape == y.shape and x.dtype == y.dtype
               and torch.equal(x, y if y.device == x.device else y.to(x.device))
               for x, y in zip(a, b))


class _Access:
    """Last access of one kind by one thread to one name."""

    __slots__ = ("clock", "site", "value", "kind", "replica")

    def __init__(self, clock: int, site: str, value, kind: str, replica: bool = False):
        self.clock = clock
        self.site = site
        self.value = value
        self.kind = kind
        self.replica = replica      # a read whose thread held its own copy of the bits


class RaceDetector:
    """Vector clocks + per-name access history.  Not thread-safe on its own:
    the owning :class:`~repro_torch.check.checker.Checker` serialises every call
    under its (leaf) lock."""

    def __init__(self):
        self._vc: Dict[Any, Dict[Any, int]] = {}
        self._pending: Dict[tuple, Dict[Any, int]] = {}
        self._spawn_vc: Optional[Dict[Any, int]] = None
        self._writes: Dict[str, Dict[Any, _Access]] = {}
        self._reads: Dict[str, Dict[Any, _Access]] = {}
        self.benign_replicated = 0   # equal-value pairs suppressed (§4.5 idiom)

    # -- clocks ---------------------------------------------------------------

    def _clock(self, tid) -> Dict[Any, int]:
        vc = self._vc.get(tid)
        if vc is None:
            vc = self._vc[tid] = {tid: 1}
        return vc

    def _bump(self, tid) -> None:
        vc = self._clock(tid)
        vc[tid] = vc.get(tid, 0) + 1

    @staticmethod
    def _merge(dst: Dict[Any, int], src: Dict[Any, int]) -> None:
        for t, c in src.items():
            if c > dst.get(t, 0):
                dst[t] = c

    # -- spawn / join edges ---------------------------------------------------

    def on_spawn(self, driver_tid=DRIVER) -> None:
        self._spawn_vc = dict(self._clock(driver_tid))
        self._bump(driver_tid)

    def bind(self, tid) -> None:
        vc = dict(self._spawn_vc) if self._spawn_vc is not None else {}
        vc[tid] = vc.get(tid, 0) + 1
        self._vc[tid] = vc

    def after_join(self, driver_tid, worker_tids) -> None:
        dst = self._clock(driver_tid)
        for tid in worker_tids:
            src = self._vc.get(tid)
            if src is not None:
                self._merge(dst, src)
        self._bump(driver_tid)

    # -- sync edges -----------------------------------------------------------

    def publish(self, tid, key: tuple) -> int:
        """Merge ``tid``'s clock into the object's pending clock; returns the
        thread's own component (the epoch a collective write is recorded at)."""
        vc = self._clock(tid)
        pending = self._pending.setdefault(key, {})
        self._merge(pending, vc)
        return vc[tid]

    def join_pending(self, tid, key: tuple) -> None:
        pending = self._pending.get(key)
        if pending:
            self._merge(self._clock(tid), pending)
        self._bump(tid)

    # -- accesses -------------------------------------------------------------

    def record_collective_write(self, tid, name: str, clock: int, site: str) -> None:
        """The accumulator's round output write, at the thread's publish-time
        epoch — dominated by every peer's clock after the round join, so the
        N per-thread records never race each other."""
        self._writes.setdefault(name, {})[tid] = _Access(clock, site, None,
                                                         "accumulate")

    def record_access(self, tid, name: str, kind: str, site: str, value):
        """Record a ``get``/``set``/``inc`` and return the race pairs it forms:
        a list of ``(kind_slug, other_tid, other_site, other_kind)`` tuples."""
        vc = self._clock(tid)
        races = []

        def unordered(other: _Access, other_tid) -> bool:
            return other_tid != tid and vc.get(other_tid, 0) < other.clock

        writes = self._writes.setdefault(name, {})
        reads = self._reads.setdefault(name, {})
        if kind == "read":
            # the replicated-read exemption needs the reader to have written
            # the same bits itself (program-ordered): then every unordered
            # copy of the value is interchangeable and the read is schedule-
            # independent.  A reader with no own copy is racy even when it
            # *happened* to observe the written bits — another schedule
            # reads the old value.
            own = writes.get(tid)
            for u, acc in writes.items():
                if unordered(acc, u):
                    if (values_equal(value, acc.value) and own is not None
                            and values_equal(own.value, acc.value)):
                        self.benign_replicated += 1
                    else:
                        races.append(("read-write", u, acc.site, acc.kind))
            replica = own is not None and values_equal(own.value, value)
            reads[tid] = _Access(vc[tid], site, value, kind, replica)
        else:  # "write" | "inc"
            for u, acc in writes.items():
                if not unordered(acc, u):
                    continue
                if kind == "inc" and acc.kind == "inc":
                    continue     # atomic increments commute (store-serialised)
                if values_equal(value, acc.value):
                    self.benign_replicated += 1
                else:
                    races.append(("write-write", u, acc.site, acc.kind))
            for u, acc in reads.items():
                if not unordered(acc, u):
                    continue
                if acc.replica and values_equal(value, acc.value):
                    self.benign_replicated += 1
                else:
                    races.append(("read-write", u, acc.site, acc.kind))
            writes[tid] = _Access(vc[tid], site, value, kind)
        return races
