"""Stall/SLO watchdog — the "is it stuck?" half of step.obs (port of
:mod:`repro.obs.watchdog`).

A :class:`Watchdog` polls a session's live state (open migration window,
in-flight barrier/semaphore waits, tier counters, per-shard lock-wait
histograms) and fires a typed :class:`Anomaly` the moment a deadline or SLO
is crossed — with a flight-recorder dump captured at detection time, so the
events *leading up to* the stall are preserved even if the process dies a
second later.

Detectors (kind → trigger):

``stalled-migration``
    An open migration window (``store.migration_window``) made no progress
    (``entries_moved + pulled`` unchanged, pending nonempty) for
    ``migration_deadline_s``.
``slow-barrier`` / ``slow-semaphore``
    Some thread has been waiting on a registered sync primitive longer than
    ``max(min_*_slo_us, slo_factor × p99)`` — the SLO is derived from the
    primitive's own latency histogram, so a workload with naturally long
    barriers doesn't false-positive.
``tier-thrash``
    Promotions ≈ demotions over the last poll window with at least
    ``thrash_min_moves`` total moves: the hot tier is churning entries in
    and out instead of holding a working set.
``lock-wait-outlier``
    One shard's lock-wait p99 exceeds ``lock_wait_factor ×`` the median
    shard's p99 (and an absolute floor) — a hot shard is serialising.
``dead-heartbeat``
    Chained from a heartbeat monitor (``on_failure`` and
    ``last_payload(node)``, the JAX package's ``HeartbeatMonitor`` surface)
    via :meth:`Watchdog.watch_heartbeats`; fires per dead node before the
    monitor's own ``on_failure`` proceeds to recovery.

The watchdog never blocks the session: every read is a lock-free attribute
peek, a counter snapshot, or a tracer-lock histogram read.  ``poll_once()``
is the deterministic unit (tests drive it directly); ``start()`` wraps it in
a daemon thread, which counts its polls (``polls``) and keeps every error a
poll raised (``errors``) instead of dying with it.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core import telemetry
from repro_torch.obs.recorder import FlightRecorder

#: anomaly kinds, stable slugs (the Anomaly catalogue in the README)
ANOMALY_KINDS = ("stalled-migration", "slow-barrier", "slow-semaphore",
                 "tier-thrash", "lock-wait-outlier", "dead-heartbeat")

#: severity levels, in increasing order of badness
SEVERITIES = ("warning", "error", "critical")


@dataclass(frozen=True)
class Anomaly:
    """One detected runtime anomaly, with its evidence attached."""

    kind: str                        # one of ANOMALY_KINDS
    severity: str                    # "warning" | "error" | "critical"
    message: str                     # human-readable, names the culprit
    detected_at: float               # unix time of detection
    details: Dict[str, Any] = field(default_factory=dict)
    dump: Optional[Dict[str, Any]] = None   # FlightRecorder.dump() capture

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "severity": self.severity,
                "message": self.message, "detected_at": self.detected_at,
                "details": dict(self.details), "dump": self.dump}


class Watchdog:
    """Deadline/SLO monitor over one session, firing :class:`Anomaly` rows.

    ``session`` is duck-typed (needs ``store``, ``tracer`` and optionally
    ``recorder`` / ``_watch_prims``) so this module never imports
    ``core.session``.  All thresholds are constructor knobs; the defaults
    are conservative enough for production polling at ``interval_s``.
    """

    def __init__(self, session, *,
                 interval_s: float = 0.25,
                 migration_deadline_s: float = 5.0,
                 barrier_slo_factor: float = 8.0,
                 min_barrier_slo_us: float = 50_000.0,
                 semaphore_slo_factor: float = 8.0,
                 min_semaphore_slo_us: float = 50_000.0,
                 lock_wait_factor: float = 8.0,
                 min_lock_wait_us: float = 20_000.0,
                 thrash_min_moves: int = 64,
                 thrash_balance: float = 0.25,
                 cooldown_s: float = 30.0,
                 dump_dir: Optional[str] = None,
                 on_anomaly: Optional[Callable[[Anomaly], None]] = None):
        self.session = session
        self.interval_s = float(interval_s)
        self.migration_deadline_s = float(migration_deadline_s)
        self.barrier_slo_factor = float(barrier_slo_factor)
        self.min_barrier_slo_us = float(min_barrier_slo_us)
        self.semaphore_slo_factor = float(semaphore_slo_factor)
        self.min_semaphore_slo_us = float(min_semaphore_slo_us)
        self.lock_wait_factor = float(lock_wait_factor)
        self.min_lock_wait_us = float(min_lock_wait_us)
        self.thrash_min_moves = int(thrash_min_moves)
        self.thrash_balance = float(thrash_balance)
        self.cooldown_s = float(cooldown_s)
        self.dump_dir = dump_dir
        self.on_anomaly = on_anomaly
        self.anomalies: List[Anomaly] = []
        self._lock = threading.Lock()
        self._seen: Dict[tuple, float] = {}      # incident key -> fired-at
        self._mig_state: Optional[tuple] = None  # (win id, progress, t_last)
        self._tier_prev: Optional[Dict[str, int]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._dump_seq = 0
        self.polls = 0                           # poll_once calls so far
        self.errors: List[str] = []              # what failed polls raised

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "Watchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="step-watchdog")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as exc:
                # a failing poll must not take the session down with it, and
                # is kept for the caller instead of dropped
                with self._lock:
                    self.errors.append(f"{type(exc).__name__}: {exc}")
            self._stop.wait(self.interval_s)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the poll -------------------------------------------------------------

    def poll_once(self) -> List[Anomaly]:
        """Run every detector once; returns the anomalies fired *this* poll
        (also appended to :attr:`anomalies`).  Deterministic — tests call
        this directly instead of racing the daemon thread."""
        fired: List[Anomaly] = []
        now = time.monotonic()
        with self._lock:
            self.polls += 1
        fired += self._check_migration(now)
        fired += self._check_sync_waits(now)
        fired += self._check_tier_thrash()
        fired += self._check_lock_outliers()
        return fired

    # stalled migration window ------------------------------------------------

    def _check_migration(self, now: float) -> List[Anomaly]:
        win = getattr(self.session.store, "migration_window", None)
        if win is None:
            self._mig_state = None
            return []
        progress = (int(getattr(win, "entries_moved", 0))
                    + int(getattr(win, "pulled", 0)))
        remaining = int(getattr(win, "remaining", 0))
        state = self._mig_state
        if state is None or state[0] != id(win) or state[1] != progress:
            self._mig_state = (id(win), progress, now)
            return []
        if remaining <= 0 or now - state[2] < self.migration_deadline_s:
            return []
        return self._fire(
            "stalled-migration", "error",
            f"migration window open {now - state[2]:.1f}s with no progress "
            f"({remaining} entries still pending)",
            {"stalled_s": now - state[2], "remaining": remaining,
             "entries_moved": int(getattr(win, "entries_moved", 0)),
             "pulled": int(getattr(win, "pulled", 0))},
            incident=("mig", id(win), progress))

    # in-flight barrier / semaphore waits ------------------------------------

    def _slo_us(self, hist_names, factor: float, floor: float) -> float:
        trc = self.session.tracer
        p99 = 0.0
        for name in hist_names:
            snap = trc.hist(name)
            if snap is not None:
                p99 = max(p99, snap["p99"])
        return max(floor, factor * p99)

    def _check_sync_waits(self, now: float) -> List[Anomaly]:
        fired: List[Anomaly] = []
        prims = list(getattr(self.session, "_watch_prims", ()))
        wall = time.perf_counter()
        for prim in prims:
            kind = getattr(prim, "watch_kind", None)
            oldest = getattr(prim, "oldest_wait_start", None)
            if kind is None or oldest is None:
                continue
            t0 = oldest()
            if t0 is None:
                continue
            wait_us = (wall - t0) * 1e6
            if kind == "barrier":
                slo = self._slo_us(("barrier.wait", "accumulate.barrier"),
                                   self.barrier_slo_factor,
                                   self.min_barrier_slo_us)
                slug, sev = "slow-barrier", "warning"
            else:
                slo = self._slo_us(("semaphore.acquire",),
                                   self.semaphore_slo_factor,
                                   self.min_semaphore_slo_us)
                slug, sev = "slow-semaphore", "warning"
            if wait_us < slo:
                continue
            fired += self._fire(
                slug, sev,
                f"{kind} wait in flight for {wait_us / 1e3:.1f}ms "
                f"(SLO {slo / 1e3:.1f}ms, p99-derived)",
                {"wait_us": wait_us, "slo_us": slo,
                 "waiters": int(getattr(prim, "waiters", lambda: 0)())},
                incident=(slug, id(prim), round(t0, 6)))
        return fired

    # tier demotion thrash ----------------------------------------------------

    def _check_tier_thrash(self) -> List[Anomaly]:
        tier_stats = getattr(self.session.store, "tier_stats", None)
        if tier_stats is None:
            return []
        stats = tier_stats()
        cur = {"promotions": int(stats.get("promotions", 0)),
               "demotions": int(stats.get("demotions", 0))}
        prev, self._tier_prev = self._tier_prev, cur
        if prev is None:
            return []
        dp = cur["promotions"] - prev["promotions"]
        dd = cur["demotions"] - prev["demotions"]
        moves = dp + dd
        if moves < self.thrash_min_moves or min(dp, dd) == 0:
            return []
        balance = min(dp, dd) / max(dp, dd)
        if balance < 1.0 - self.thrash_balance:
            return []
        return self._fire(
            "tier-thrash", "warning",
            f"hot tier churning: {dp} promotions vs {dd} demotions in one "
            f"poll window (balance {balance:.2f})",
            {"promotions": dp, "demotions": dd, "balance": balance},
            incident=("thrash",))   # one ongoing churn = one incident; the
                                    # cooldown alone governs re-fires

    # per-shard lock-wait outliers -------------------------------------------

    def _check_lock_outliers(self) -> List[Anomaly]:
        per = self.session.tracer.shard_hist("store.lock_wait")
        if len(per) < 2:
            return []
        p99s = {sid: snap["p99"] for sid, snap in per.items()}
        ranked = sorted(p99s.values())
        median = ranked[len(ranked) // 2]
        fired: List[Anomaly] = []
        for sid, p99 in p99s.items():
            if p99 < self.min_lock_wait_us:
                continue
            if p99 < self.lock_wait_factor * max(median, 1.0):
                continue
            fired += self._fire(
                "lock-wait-outlier", "warning",
                f"shard {sid} lock-wait p99 {p99 / 1e3:.1f}ms vs median "
                f"{median / 1e3:.3f}ms across {len(p99s)} shards",
                {"shard": sid, "p99_us": p99, "median_us": median},
                incident=("lockwait", sid))
        return fired

    # heartbeat escalation ----------------------------------------------------

    def watch_heartbeats(self, monitor) -> Any:
        """Chain onto a heartbeat monitor (duck-typed: ``on_failure`` and
        ``last_payload(node_id)``, as the JAX package's ``HeartbeatMonitor``
        has them): each newly dead node fires a ``dead-heartbeat`` anomaly (dump included)
        *before* the monitor's original ``on_failure`` runs recovery."""
        prev = monitor.on_failure

        def _on_failure(dead_nodes):
            for node_id in dead_nodes:
                payload = monitor.last_payload(node_id)
                self._fire("dead-heartbeat", "critical",
                           f"node {node_id} heartbeat lost",
                           {"node": node_id, "last_payload": payload},
                           incident=("dead", node_id))
            if prev is not None:
                prev(dead_nodes)

        monitor.on_failure = _on_failure
        return monitor

    # firing ------------------------------------------------------------------

    def _recorder(self) -> Optional[FlightRecorder]:
        rec = getattr(self.session, "recorder", None)
        return rec if isinstance(rec, FlightRecorder) else None

    def _fire(self, kind: str, severity: str, message: str,
              details: Dict[str, Any],
              incident: Optional[tuple] = None) -> List[Anomaly]:
        now = time.monotonic()
        key = (kind,) + (incident if incident is not None else ())
        with self._lock:
            last = self._seen.get(key)
            if last is not None and now - last < self.cooldown_s:
                return []
            self._seen[key] = now
        # breadcrumb first, so the mark is *inside* the dump we then capture
        trc = self.session.tracer
        if telemetry.TRACING and trc.enabled:
            trc.mark("anomaly", kind, severity=severity, message=message)
        dump = None
        rec = self._recorder()
        if rec is not None and rec.armed:
            dump = rec.dump(reason=kind)
        anomaly = Anomaly(kind=kind, severity=severity, message=message,
                          detected_at=time.time(), details=details, dump=dump)
        if self.dump_dir is not None and dump is not None:
            os.makedirs(self.dump_dir, exist_ok=True)
            with self._lock:
                self._dump_seq += 1
                seq = self._dump_seq
            path = os.path.join(self.dump_dir, f"anomaly-{seq:04d}-{kind}.json")
            with open(path, "w") as f:
                json.dump(anomaly.as_dict(), f)
            details["dump_path"] = path
        with self._lock:
            self.anomalies.append(anomaly)
        if self.on_anomaly is not None:
            self.on_anomaly(anomaly)
        return [anomaly]

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Watchdog(anomalies={len(self.anomalies)}, "
                f"interval_s={self.interval_s})")
