"""Lock-order sanitizer + wait-for cycle detection (step.check layer 2; port
of :mod:`repro.check.locks`, unchanged).

The repo's internal locking invariants have so far lived only in docstrings
(`shards.py` / `cache.py`): the order is strictly **shard → node-cache**, the
rebalancer takes every involved shard lock in **sorted id** order, and the
allocator lock never nests with either.  This module turns those comments
into runtime assertions: every shard/node/alloc acquisition is checked
against the calling thread's held-lock stack.

Lock keys are ``("shard", id)`` / ``("node", id)`` / ``("alloc", 0)``.  Shard
locks are RLocks (the cache composes store ops while holding one), so a
re-acquisition of the *same* shard is always legal.

The second half watches user-level sync: which semaphores each STEP thread
holds and what every blocked thread is waiting on.  A wait-for graph over the
*blocked* threads (barrier waiters point at the threads that have not arrived;
semaphore waiters point at the holders) is searched for cycles on every
block — the "thread parked on barrier X while holding semaphore Y that the
missing thread needs" deadlock.  A barrier no remaining live thread can ever
fill (arity > live threads, everyone already parked) is reported as starved.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set, Tuple

LockKey = Tuple[str, int]


def check_order(held: List[LockKey], key: LockKey, rebalance: bool,
                handoff: bool = False) -> Optional[Tuple[str, str]]:
    """Validate acquiring ``key`` while holding ``held`` (oldest first).
    Returns ``(kind_slug, message)`` on a violation, else None.  Pure
    function — the caller owns all state.

    ``rebalance`` is the stop-the-world exemption (any number of shard locks,
    sorted).  ``handoff`` is the incremental arc-handoff exemption: exactly
    one *pair* of shard locks, sorted — a migration window moves one entry at
    a time, so a third shard lock under the handoff flag is a bug."""
    domain, ident = key
    if domain == "shard":
        for hd, hi in held:
            if hd == "node":
                return ("lock-order-inversion",
                        f"shard {ident} lock requested while holding node "
                        f"{hi} lock — documented order is shard → node")
            if hd == "alloc":
                return ("lock-order-inversion",
                        f"shard {ident} lock requested under the allocator "
                        "lock — the alloc lock must not nest")
            if hd == "shard" and hi != ident:
                if not rebalance and not handoff:
                    return ("shard-shard-nesting",
                            f"shard {ident} lock requested while holding "
                            f"shard {hi} — only the rebalancer or an arc "
                            "handoff may hold two shards, in sorted id order")
                if hi > ident:
                    return ("rebalance-unsorted" if rebalance
                            else "handoff-unsorted",
                            f"{'rebalance' if rebalance else 'arc handoff'} "
                            f"acquired shard {ident} after shard {hi} — "
                            "shard locks must be taken in sorted id order")
                if handoff and not rebalance:
                    others = {i for d, i in held if d == "shard" and i != ident}
                    if len(others) >= 2:
                        return ("handoff-pair-overflow",
                                f"arc handoff requested shard {ident} while "
                                f"already holding shards {sorted(others)} — "
                                "a handoff moves one entry under exactly two "
                                "shard locks")
    elif domain == "node":
        for hd, hi in held:
            if hd == "node" and hi != ident:
                return ("lock-order-inversion",
                        f"node {ident} lock requested while holding node "
                        f"{hi} — node locks never nest")
            if hd == "alloc":
                return ("lock-order-inversion",
                        f"node {ident} lock requested under the allocator "
                        "lock — the alloc lock must not nest")
    elif domain == "alloc":
        if held:
            return ("lock-order-inversion",
                    f"allocator lock requested while holding {held[-1]} — "
                    "the alloc lock is a leaf and must be taken bare")
    return None


class LockSanitizer:
    """Wait-for graph over user sync primitives.  Held-lock stacks live in
    the checker's thread-locals; this class owns only cross-thread state and,
    like the race detector, runs under the checker's leaf lock."""

    def __init__(self):
        # semaphore key -> STEP tids currently holding a permit
        self._holders: Dict[tuple, Set[Any]] = {}
        # STEP tid -> (kind, key, obj) it is currently blocked on
        self._blocked: Dict[Any, Tuple[str, tuple, Any]] = {}

    def clear(self) -> None:
        self._holders.clear()
        self._blocked.clear()

    def sem_acquired(self, tid, key: tuple) -> None:
        self._holders.setdefault(key, set()).add(tid)

    def sem_released(self, tid, key: tuple) -> None:
        holders = self._holders.get(key)
        if not holders:
            return
        if tid in holders:
            holders.discard(tid)
        else:           # §5.3 allows releases from a non-holder thread
            holders.pop()

    def held_semaphores(self, tid) -> List[tuple]:
        return [key for key, holders in self._holders.items() if tid in holders]

    def block(self, tid, kind: str, key: tuple, obj,
              live: Set[Any]) -> List[Tuple[str, str, Tuple[Any, ...]]]:
        """Register ``tid`` as blocked and scan for deadlock.  Returns
        ``(kind_slug, message, tids)`` findings."""
        self._blocked[tid] = (kind, key, obj)
        return self._detect(live)

    def unblock(self, tid) -> None:
        self._blocked.pop(tid, None)

    # -- deadlock detection ---------------------------------------------------

    def _waiters(self, key: tuple) -> Set[Any]:
        return {t for t, (_, kk, _) in self._blocked.items() if kk == key}

    def _detect(self, live: Set[Any]) -> List[Tuple[str, str, Tuple[Any, ...]]]:
        out: List[Tuple[str, str, Tuple[Any, ...]]] = []
        # starved barrier: every live thread is already parked on it, yet the
        # arity still isn't met — no thread remains that could fill it
        for kind, key, obj in self._blocked.values():
            if kind != "barrier":
                continue
            waiters = self._waiters(key)
            count = getattr(obj, "count", len(waiters))
            if live and waiters >= live and len(waiters) < count:
                out.append((
                    "starved-barrier",
                    f"barrier (count={count}) has every live thread parked "
                    f"but only {len(waiters)} arrival(s) — it can never "
                    "release", tuple(sorted(waiters, key=str))))
        # fixed point over "can this thread ever proceed": any non-blocked
        # participant can; a semaphore waiter can when a permit is free or
        # ANY holder can proceed (OR-wait: one release suffices); a barrier
        # waiter can when the arity is met or EVERY missing live thread can
        # still arrive (AND-wait).  Whatever never gets marked is deadlocked.
        blocked = set(self._blocked)
        participants = set(live) | blocked
        for holders in self._holders.values():
            participants |= holders
        can = participants - blocked
        changed = True
        while changed:
            changed = False
            for tid in blocked - can:
                kind, key, obj = self._blocked[tid]
                if kind == "semaphore":
                    holders = set(self._holders.get(key, ())) - {tid}
                    ok = (getattr(obj, "_count", 0) > 0 or not holders
                          or bool(holders & can))
                else:
                    waiters = self._waiters(key)
                    missing = (live - waiters) if live else set()
                    count = getattr(obj, "count", len(waiters))
                    ok = (len(waiters) >= count
                          or (bool(missing) and missing <= can))
                if ok:
                    can.add(tid)
                    changed = True
        dead = blocked - can
        # a single stuck thread is ambiguous (an unbound helper thread could
        # still release it); two or more waiting on each other is a deadlock
        if len(dead) >= 2:
            parts = []
            for t in sorted(dead, key=str):
                kind, _, _ = self._blocked[t]
                held = self.held_semaphores(t)
                held_s = f" holding semaphore(s) {held}" if held else ""
                parts.append(f"thread {t} blocked on {kind}{held_s}")
            out.append(("wait-cycle",
                        "deadlock cycle: " + "; ".join(parts),
                        tuple(sorted(dead, key=str))))
        return out
