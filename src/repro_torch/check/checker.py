"""step.check — the correctness-analysis facade, armed like the tracer (port
of :mod:`repro.check.checker`).

``Session(check=True)`` arms a :class:`Checker`; every instrumented hot path
in ``session.py`` / ``sync.py`` / ``shards.py`` / ``cache.py`` /
``accumulator.py`` guards its hook with the module-level :data:`CHECKING`
flag first, exactly like ``telemetry.TRACING`` — when no checker is armed the
added cost is one module-attribute load and a falsy branch, and nothing is
allocated.

The checker multiplexes three layers over one findings model
(:mod:`repro_torch.check.findings`):

* :mod:`repro_torch.check.races` — vector-clock happens-before race detection over
  ``SharedRef`` get/set/inc on the host backend;
* :mod:`repro_torch.check.locks` — the shard→node/alloc lock-order sanitizer plus
  wait-for-cycle (deadlock) detection across DBarrier/DSemaphore;
* :mod:`repro_torch.check.lint` — the spawn-time dry run that rejects structurally
  broken programs (barrier arity, ragged accumulates, host sync under SPMD)
  before any thread starts.

The checker's lock is a leaf in the locking order: hook bodies never call
back into store/sync code.  Thread identity (STEP tid, held-lock stack, the
lint-dry-run flag) lives in thread-locals, so per-thread state needs no lock
at all.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

from repro_torch.check.findings import CheckError, Finding, call_site
from repro_torch.check.locks import LockSanitizer, check_order
from repro_torch.check.races import DRIVER, RaceDetector, snapshot_value

# ---------------------------------------------------------------------------
# Module-level fast path: CHECKING is True iff at least one Checker is armed.
# Hot paths check `stepcheck.CHECKING` BEFORE touching their checker, so the
# disabled-by-default cost is a module attribute load + branch.
# ---------------------------------------------------------------------------

CHECKING = False

_armed: set = set()
_armed_lock = threading.Lock()


def _arm(checker: "Checker") -> None:
    global CHECKING
    with _armed_lock:
        _armed.add(checker)
        CHECKING = True


def _disarm(checker: "Checker") -> None:
    global CHECKING
    with _armed_lock:
        _armed.discard(checker)
        CHECKING = bool(_armed)


def armed_count() -> int:
    """How many checkers are currently enabled (the leak-check hook: tier-1
    tests must leave this at 0, enforced by an autouse conftest fixture)."""
    with _armed_lock:
        return len(_armed)


def reset() -> int:
    """Disable every armed checker; returns how many were disabled."""
    with _armed_lock:
        leaked = list(_armed)
    for c in leaked:
        c.disable()
    return len(leaked)


class Checker:
    """One session's correctness analyses behind one findings list.

    ``strict=True`` (the default) makes error-severity *lint* findings raise
    :class:`CheckError` from ``Session.spawn`` — the program is rejected
    before any thread runs.  Race and lock findings are dynamic and only
    recorded (the run that produced them has already happened).
    """

    def __init__(self, enabled: bool = False, *, strict: bool = True,
                 max_findings: int = 1000):
        self.enabled = False
        self.strict = strict
        self.max_findings = max_findings
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._races = RaceDetector()
        self._locks = LockSanitizer()
        self._findings: List[Finding] = []
        self._seen: set = set()
        self.dropped = 0
        self._bound: set = set()      # live worker tids (bind → join window)
        self._expected = 0            # spawn cohort size (spawn → join window)
        if enabled:
            self.enable()

    # -- arming ---------------------------------------------------------------

    def enable(self) -> "Checker":
        if not self.enabled:
            self.enabled = True
            _arm(self)
        return self

    def disable(self) -> "Checker":
        if self.enabled:
            self.enabled = False
            _disarm(self)
        return self

    def __enter__(self) -> "Checker":
        return self.enable()

    def __exit__(self, *exc) -> None:
        self.disable()

    # -- identity -------------------------------------------------------------

    def _tid(self):
        return getattr(self._tls, "tid", DRIVER)

    def bind_thread(self, tid, node_id: int = 0) -> None:
        """Attach the calling OS thread to a STEP tid (HostBackend spawn)."""
        self._tls.tid = tid
        with self._lock:
            self._bound.add(tid)
            self._races.bind(tid)

    # -- findings -------------------------------------------------------------

    def _emit(self, finding: Finding) -> None:
        """Record one finding (checker lock held); dedupes and caps."""
        key = finding.key()
        if key in self._seen:
            return
        if len(self._findings) >= self.max_findings:
            self.dropped += 1
            return
        self._seen.add(key)
        self._findings.append(finding)

    def record(self, finding: Finding) -> None:
        with self._lock:
            self._emit(finding)

    def findings(self) -> List[Finding]:
        with self._lock:
            return list(self._findings)

    @property
    def benign_replicated(self) -> int:
        """Equal-value unordered write pairs suppressed as the sanctioned
        bulk-synchronous replicated-set idiom (session.py contract)."""
        with self._lock:
            return self._races.benign_replicated

    def report(self) -> Dict[str, Any]:
        with self._lock:
            per_layer: Dict[str, int] = {}
            per_severity: Dict[str, int] = {}
            for f in self._findings:
                per_layer[f.layer] = per_layer.get(f.layer, 0) + 1
                per_severity[f.severity] = per_severity.get(f.severity, 0) + 1
            return {"findings": [f.as_dict() for f in self._findings],
                    "count": len(self._findings),
                    "by_layer": per_layer,
                    "by_severity": per_severity,
                    "benign_replicated_writes": self._races.benign_replicated,
                    "dropped": self.dropped}

    def export(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.report(), fh, indent=2)
        return path

    # -- spawn / join edges (session.py hooks) --------------------------------

    def on_spawn(self, n_threads: int) -> None:
        with self._lock:
            self._expected = n_threads
            self._races.on_spawn(self._tid())

    def after_join(self) -> None:
        with self._lock:
            self._races.after_join(self._tid(), tuple(self._bound))
            self._bound.clear()
            self._expected = 0
            self._locks.clear()

    def _live(self) -> set:
        """The deadlock detector's live set (checker lock held): the bound
        worker tids — but only once the whole spawn cohort has bound.  While
        threads are still launching, "every live thread is parked" is a
        startup race, not starvation, so the set is empty (which disables
        the starvation rule but keeps genuine wait-cycle detection)."""
        if len(self._bound) < self._expected:
            return set()
        return set(self._bound)

    # -- SharedRef accesses (session.py hooks, host/driver only) --------------

    def on_access(self, name: str, kind: str, value) -> None:
        if getattr(self._tls, "lint", None) is not None:
            return                      # dry run: structure only, no races
        site = call_site()
        snap = snapshot_value(value)
        tid = self._tid()
        with self._lock:
            for slug, other_tid, other_site, other_kind in \
                    self._races.record_access(tid, name, kind, site, snap):
                a, b = sorted([f"{kind} by {tid} at {site}",
                               f"{other_kind} by {other_tid} at {other_site}"])
                self._emit(Finding(
                    "race", slug, "error",
                    f"unsynchronized {slug} on {name!r}: {a} vs {b} — no "
                    "happens-before edge orders them and the values differ",
                    name=name,
                    sites=tuple(sorted({site, other_site})),
                    tids=tuple(sorted({tid, other_tid}, key=str))))

    # -- sync hooks (sync.py) -------------------------------------------------

    def lint_sync(self, obj, kind: str) -> Optional[bool]:
        """Absorb a sync-primitive call under the lint dry run: record the
        reach, block on nothing, mutate nothing.  Returns None in real runs
        (the caller proceeds normally)."""
        run = getattr(self._tls, "lint", None)
        if run is None:
            return None
        run.reach_sync(kind, obj, self._tls.lint_tid)
        return True

    def _begin_lint(self, run, tid) -> None:
        self._tls.lint = run
        self._tls.lint_tid = tid

    def _end_lint(self) -> None:
        self._tls.lint = None
        self._tls.lint_tid = None

    def sync_block(self, obj, kind: str) -> None:
        """About to block on a barrier/semaphore: publish the happens-before
        edge source (barriers only) and scan the wait-for graph."""
        tid = self._tid()
        key = (kind, id(obj))
        with self._lock:
            if kind == "barrier":
                self._races.publish(tid, key)
            for slug, message, tids in self._locks.block(
                    tid, kind, key, obj, self._live()):
                self._emit(Finding("lock", slug, "error", message, tids=tids))

    def sync_unblock(self, obj, kind: str, ok: bool) -> None:
        tid = self._tid()
        key = (kind, id(obj))
        with self._lock:
            self._locks.unblock(tid)
            if ok:
                if kind == "semaphore":
                    self._locks.sem_acquired(tid, key)
                self._races.join_pending(tid, key)

    def sem_release(self, obj) -> None:
        tid = self._tid()
        key = ("semaphore", id(obj))
        with self._lock:
            self._races.publish(tid, key)
            self._locks.sem_released(tid, key)

    def ssp_tick(self, obj) -> None:
        with self._lock:
            self._races.publish(self._tid(), ("ssp", id(obj)))

    def ssp_wait_done(self, obj, ok: bool) -> None:
        if ok:
            with self._lock:
                self._races.join_pending(self._tid(), ("ssp", id(obj)))

    # -- accumulator round hooks (accumulator.py) -----------------------------

    def acc_begin(self, obj) -> int:
        """Publish this thread's clock into the round edge; returns the
        publish-time epoch the collective write is recorded at."""
        with self._lock:
            return self._races.publish(self._tid(), ("accumulate", id(obj)))

    def acc_done(self, obj, output_name: str, token: int) -> None:
        tid = self._tid()
        with self._lock:
            self._races.join_pending(tid, ("accumulate", id(obj)))
            self._races.record_collective_write(tid, output_name, token,
                                                "accumulate-round")

    # -- internal lock hooks (shards.py / cache.py) ---------------------------

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def lock_acquired(self, key) -> None:
        held = self._held()
        violation = check_order(held, key,
                                getattr(self._tls, "rebalance", False),
                                getattr(self._tls, "handoff", False))
        if violation is not None:
            slug, message = violation
            site = call_site()
            with self._lock:
                self._emit(Finding("lock", slug, "error",
                                   f"{message} (at {site})",
                                   sites=(site,), tids=(self._tid(),)))
        held.append(tuple(key))

    def lock_released(self, key) -> None:
        held = self._held()
        key = tuple(key)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == key:
                del held[i]
                return

    def rebalance_begin(self) -> None:
        self._tls.rebalance = True

    def rebalance_end(self) -> None:
        self._tls.rebalance = False

    def handoff_begin(self) -> None:
        """Arm the arc-handoff exemption for the calling thread: a migration
        window may hold exactly one sorted pair of shard locks."""
        self._tls.handoff = True

    def handoff_end(self) -> None:
        self._tls.handoff = False

    # -- lint entry points (session.py hooks) ---------------------------------

    def lint_spawn(self, session, thread_proc, data, broadcast) -> None:
        """The spawn-time dry run; raises :class:`CheckError` under strict
        mode when it finds error-severity hazards."""
        from repro_torch.check.lint import run_lint

        found = run_lint(self, session, thread_proc, data, broadcast)
        errors = [f for f in found if f.severity == "error"]
        with self._lock:
            for f in found:
                self._emit(f)
        if self.strict and errors:
            raise CheckError(errors)

    def lint_sparse_budget(self, name: str, size: int, k: int) -> None:
        """Declaration-time sparse budget check (new_array/def_global)."""
        from repro_torch.check.lint import check_sparse_budget

        with self._lock:
            for f in check_sparse_budget(name, size, k):
                self._emit(f)

    def check_delete(self, name: str, holders) -> None:
        """``delete`` of a name whose replicas are still live on nodes."""
        site = call_site()
        with self._lock:
            self._emit(Finding(
                "lint", "delete-live-replicas", "warning",
                f"delete({name!r}) at {site} with live cache replicas on "
                f"node(s) {sorted(holders)} — replicas and directory records "
                "are purged, but a concurrent reader of the deleted era may "
                "be mid-flight", name=name, sites=(site,)))


NULL_CHECKER = Checker(enabled=False)


def as_checker(check) -> Checker:
    """Resolve ``Session(check=...)``: a :class:`Checker` is adopted as-is
    (recovery re-arms the dead session's checker this way), ``True`` arms a
    fresh one, ``None``/``False`` give a fresh *disabled* checker that can be
    armed later via ``session.checker.enable()``."""
    if isinstance(check, Checker):
        return check
    return Checker(enabled=bool(check))
