"""step.obs for the port: only the disabled flight recorder exists so far.

``Session(record=None)`` gets :data:`NULL_RECORDER`, whose ``attach`` only
remembers the tracer.  Arming a recorder, the watchdog and the OpenMetrics
export wait for their slice (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations


class FlightRecorder:
    """The disarmed recorder: ``enabled`` is False and recording never starts."""

    enabled = False

    def __init__(self):
        self.tracer = None

    def attach(self, tracer) -> "FlightRecorder":
        self.tracer = tracer
        return self


def as_recorder(record) -> FlightRecorder:
    """Resolve ``Session(record=...)``: only ``None`` (recording off) exists."""
    if record is None:
        return FlightRecorder()
    raise NotImplementedError(
        "Session(record=...) needs step.obs, which is not ported yet "
        "(ROADMAP Queue 1 item 8); pass record=None")


def not_ported(feature: str) -> NotImplementedError:
    """The error every step.obs entry point of the Session raises for now."""
    return NotImplementedError(
        f"{feature} needs step.obs, which is not ported yet "
        "(ROADMAP Queue 1 item 8)")
