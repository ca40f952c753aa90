"""step.check's disabled surface — the part the core modules call.

The core modules guard every checker hook with the module-level
:data:`CHECKING` flag, exactly as :mod:`repro.check.checker` arms them.  This
slice of the port carries only the disabled checker: ``CHECKING`` stays
False, so no hook body ever runs, and arming a checker raises until the
race detector, lock sanitizer and lint are ported (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

CHECKING = False


class Checker:
    """The disarmed checker: ``enabled`` is False and stays False."""

    enabled = False


NULL_CHECKER = Checker()


def as_checker(check) -> Checker:
    """Resolve ``Session(check=...)``: only ``None`` (checking off) exists."""
    if check is None:
        return NULL_CHECKER
    raise NotImplementedError(
        "Session(check=...) needs step.check, which is not ported yet "
        "(ROADMAP Queue 1 item 8); pass check=None")
