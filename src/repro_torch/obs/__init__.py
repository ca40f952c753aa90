"""step.obs — always-on flight recorder, stall/SLO watchdog, and
OpenMetrics export (port of :mod:`repro.obs`).

The production observability surface over ``step.trace``'s measurement
substrate, in three parts:

* :class:`FlightRecorder` — a bounded ring of recent trace events, cheap
  enough to leave armed always (``Session(record=True)``): histograms and
  counters accumulate at full fidelity while only slow or lifecycle events
  materialise, so the last moments before an incident are always dumpable.
* :class:`Watchdog` — polls live session state (open migration windows,
  in-flight barrier/semaphore waits, tier churn, per-shard lock waits,
  heartbeats via :meth:`Watchdog.watch_heartbeats`) and fires typed
  :class:`Anomaly` findings with an automatic flight-recorder dump.
* :func:`openmetrics` — ``Session.metrics()`` rendered to the OpenMetrics /
  Prometheus text format (``Session.openmetrics()`` is the wrapper;
  ``scripts/torch_step_top.py`` over :mod:`repro_torch.obs.top` is the
  human-facing live view).

Import discipline: this package sits *between* ``core.telemetry`` (which it
imports) and ``core.session`` (which imports it) — nothing here may import
``repro_torch.core`` package attributes or ``core.session``.
"""

from repro_torch.obs.export import openmetrics
from repro_torch.obs.recorder import FlightRecorder, as_recorder
from repro_torch.obs.watchdog import ANOMALY_KINDS, Anomaly, SEVERITIES, Watchdog

__all__ = ["ANOMALY_KINDS", "Anomaly", "FlightRecorder", "SEVERITIES",
           "Watchdog", "as_recorder", "openmetrics"]
