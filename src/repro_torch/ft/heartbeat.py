"""Heartbeat failure detection — STEP §5.4 (port of :mod:`repro.ft.heartbeat`).

Every slave sends heartbeats to the master; a slave silent for longer than the
timeout is declared dead and recovery starts.  This is a host-side control
plane and ports unchanged: workers (threads here, hosts on a real pod) beat a
monitor; the monitor invokes an ``on_failure`` callback with the dead node ids.
A ``virtual_barrier`` pause (the paper's "checkpoint" command for async tasks)
is exposed as ``pause``/``resume`` events the workers poll.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set


#: Canonical key set of one heartbeat payload.  Dashboards and exporters key
#: off this — every :func:`metrics_payload` carries exactly these fields, on
#: every session flavour, whether or not tracing/recording/migration ever ran.
PAYLOAD_KEYS = ("trace_enabled", "record_armed", "op_rates",
                "barrier_wait_us", "wire_traffic", "rebalance")

#: Canonical key set of the payload's ``rebalance`` record (the store's
#: lifetime migration totals plus live-window state).  A store that never
#: migrated — or one without migration support at all — still emits every
#: key, zeroed, so the dashboard column set is stable from the first beat.
REBALANCE_KEYS = ("windows", "entries_moved", "bytes_moved", "pulled",
                  "window_s", "open", "pending")

_REBALANCE_ZERO = {"windows": 0, "entries_moved": 0, "bytes_moved": 0,
                   "pulled": 0, "window_s": 0.0, "open": False, "pending": 0}


def metrics_payload(session) -> Dict[str, Any]:
    """A compact metrics snapshot for heartbeat payloads: op rates plus
    barrier-wait latency quantiles, pulled from the session's tracer.  Cheap
    (a handful of dict reads) and safe on a disabled tracer — everything
    degenerates to zeros.  Key set pinned by :data:`PAYLOAD_KEYS` /
    :data:`REBALANCE_KEYS`."""
    snap = session.tracer.snapshot()
    ops = snap.get("ops", {})
    # barrier time has two sources: explicit DBarrier.enter waits and the
    # accumulator's round barrier — merge them (count sums; quantiles take
    # the slower source, a conservative straggler signal)
    waits = [ops[n] for n in ("barrier.wait", "accumulate.barrier") if n in ops]
    # lifetime rebalance totals (windows, entries/bytes moved, reader pulls,
    # open-window flag) — lets the monitor see a live migration.  Built onto
    # the zero record so the key set never depends on the store's history.
    totals = getattr(session.store, "migration_totals", dict)()
    rebalance = {k: totals.get(k, _REBALANCE_ZERO[k]) for k in REBALANCE_KEYS}
    recorder = getattr(session, "recorder", None)
    return {
        "trace_enabled": snap.get("enabled", False),
        "record_armed": bool(recorder is not None and recorder.armed),
        "op_rates": {name: row.get("rate_per_s", 0.0)
                     for name, row in ops.items()},
        "barrier_wait_us": {
            "p50": max((w["p50"] for w in waits), default=0.0),
            "p99": max((w["p99"] for w in waits), default=0.0),
            "count": sum(w["count"] for w in waits),
        },
        "wire_traffic": session.wire_traffic(),
        "rebalance": rebalance,
    }


class HeartbeatMonitor:
    def __init__(self, node_ids: List[int], timeout: float = 0.5,
                 check_interval: float = 0.05,
                 on_failure: Optional[Callable[[List[int]], None]] = None):
        self.timeout = timeout
        self.check_interval = check_interval
        self.on_failure = on_failure
        self._last: Dict[int, float] = {n: time.monotonic() for n in node_ids}
        self._payloads: Dict[int, Any] = {}
        self._dead: Set[int] = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._pause = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- slave side ------------------------------------------------------------

    def beat(self, node_id: int, payload: Optional[Any] = None) -> None:
        """Record a heartbeat; ``payload`` (typically :func:`metrics_payload`)
        piggybacks the node's latest metrics snapshot on the liveness signal,
        so the master sees op rates and barrier-wait quantiles without a
        second channel."""
        with self._lock:
            if node_id not in self._dead:
                self._last[node_id] = time.monotonic()
                if payload is not None:
                    self._payloads[node_id] = payload

    # -- master-side payload inspection ----------------------------------------

    def last_payload(self, node_id: int) -> Optional[Any]:
        with self._lock:
            return self._payloads.get(node_id)

    def payloads(self) -> Dict[int, Any]:
        with self._lock:
            return dict(self._payloads)

    def should_pause(self) -> bool:
        """Workers poll this at barrier boundaries (virtual-barrier checkpoint)."""
        return self._pause.is_set()

    # -- master side -------------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            newly_dead = []
            with self._lock:
                for n, t in self._last.items():
                    if n not in self._dead and now - t > self.timeout:
                        self._dead.add(n)
                        newly_dead.append(n)
            if newly_dead and self.on_failure is not None:
                self.on_failure(newly_dead)
            time.sleep(self.check_interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def pause(self) -> None:
        """Broadcast the paper's 'checkpoint' command (enforce a virtual barrier)."""
        self._pause.set()

    def resume(self) -> None:
        self._pause.clear()

    def dead_nodes(self) -> List[int]:
        with self._lock:
            return sorted(self._dead)

    def declare_dead(self, node_id: int) -> None:
        """Test/drill hook: fail a node immediately."""
        with self._lock:
            self._dead.add(node_id)
        if self.on_failure is not None:
            self.on_failure([node_id])

    def revive(self, node_id: int) -> None:
        with self._lock:
            self._dead.discard(node_id)
            self._last[node_id] = time.monotonic()
