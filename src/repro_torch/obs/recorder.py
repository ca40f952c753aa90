"""Flight recorder — the always-on half of step.obs (port of
:mod:`repro.obs.recorder`).

A :class:`FlightRecorder` keeps the last N trace events in a bounded
:class:`~repro_torch.core.telemetry.RingSink` so that *when* something goes wrong
(a stalled migration window, a straggler barrier, a dead node) there is
evidence to dump — without paying full `step.trace` cost in the meantime.

Arming contract (``Session(record=True)``):

* If the session's tracer is **disabled** (the default), the recorder arms
  it in *record-only* mode: histograms and counters accumulate as usual,
  but span events are materialised only into the ring, and only when slow
  (``duration >= slow_us``) or in an always-record category
  (:data:`~repro_torch.core.telemetry.ALWAYS_RECORD` — migration windows, SPMD
  phases, anomaly marks).  Fast ops allocate nothing, the unbounded
  ``_events`` list stays empty, and memory is O(capacity) forever.
* If the tracer is already **enabled** (``Session(trace=True, record=True)``),
  full tracing continues unchanged; the recorder just hangs its ring off the
  tracer so the *recent* window is dump-able without walking 200k events.

``dump()`` captures a JSON-safe snapshot (events + counters + hist
quantiles); ``export()`` writes it to disk.  ``close()`` disarms whatever
the recorder armed — tests (and tidy shutdown paths) call it so the
module-level ``TRACING`` flag drops back when the session is done.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from repro_torch.core import telemetry


class FlightRecorder:
    """Bounded always-on event recorder over a session's tracer."""

    def __init__(self, *, capacity: int = 4096, slow_us: float = 1000.0,
                 enabled: bool = True):
        self.capacity = int(capacity)
        self.slow_us = float(slow_us)
        self.enabled = bool(enabled)
        self.tracer: Optional[telemetry.Tracer] = None
        self._armed_tracer = False   # recorder enabled the tracer itself

    # -- arming ---------------------------------------------------------------

    def attach(self, tracer: telemetry.Tracer) -> "FlightRecorder":
        """Hang the ring off ``tracer`` and arm record-only mode when the
        tracer isn't already running full tracing.  Idempotent; a disabled
        recorder only remembers the tracer (so ``dump()`` stays callable,
        returning an eventless capture)."""
        self.tracer = tracer
        if not self.enabled:
            return self
        if tracer.ring is None:
            tracer.ring = telemetry.RingSink(self.capacity)
        if not tracer.enabled:
            tracer.record_only = True
            tracer.slow_us = self.slow_us
            tracer.enable()
            self._armed_tracer = True
        return self

    @property
    def armed(self) -> bool:
        """True when events are currently flowing into the ring."""
        t = self.tracer
        return bool(self.enabled and t is not None and t.enabled
                    and t.ring is not None)

    def close(self) -> "FlightRecorder":
        """Disarm whatever :meth:`attach` armed.  A tracer the *user* enabled
        (full tracing) is left running — the recorder only undoes itself."""
        t = self.tracer
        if t is not None and self._armed_tracer:
            t.disable()
            t.record_only = False
            self._armed_tracer = False
        return self

    detach = close

    # -- capture --------------------------------------------------------------

    def events(self) -> List[dict]:
        """Ring contents oldest→newest (empty when never attached/armed)."""
        return self.tracer.ring_events() if self.tracer is not None else []

    def dump(self, reason: str = "manual") -> Dict[str, Any]:
        """A JSON-safe capture of the ring plus the tracer's counters and
        latency quantiles — the artifact the watchdog attaches to an
        :class:`~repro_torch.obs.watchdog.Anomaly` (and, in the JAX package,
        recovery attaches to its ``RecoveryPlan``)."""
        t = self.tracer
        events = self.events()
        snap = t.snapshot() if t is not None else {}
        ring = snap.get("ring")
        return {
            "reason": reason,
            "captured_at_unix": time.time(),
            "record_only": bool(snap.get("record_only", False)),
            "ring": ring if ring is not None else
                    {"capacity": self.capacity, "held": 0, "total": 0},
            "events": events,
            "counters": snap.get("counters", {}),
            "ops": snap.get("ops", {}),
        }

    def export(self, path: str, reason: str = "manual") -> str:
        """Write :meth:`dump` to ``path`` as JSON; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.dump(reason), f)
        return path

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        held = len(self.tracer.ring) if (self.tracer is not None and
                                         self.tracer.ring is not None) else 0
        return (f"FlightRecorder(armed={self.armed}, held={held}, "
                f"capacity={self.capacity})")


def as_recorder(record) -> FlightRecorder:
    """Resolve ``Session(record=...)``, mirroring ``as_tracer``: a
    :class:`FlightRecorder` is adopted as-is (recovery re-attaches the dead
    session's recorder this way), ``True`` builds an enabled recorder,
    ``None``/``False`` a disabled one (attach is then a no-op beyond
    remembering the tracer)."""
    if isinstance(record, FlightRecorder):
        return record
    return FlightRecorder(enabled=bool(record))
