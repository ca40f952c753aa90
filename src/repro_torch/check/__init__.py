"""step.check — happens-before race detection, lock-order sanitizing, and a
spawn-time lint pass for STEP programs (port of :mod:`repro.check`).

Armed per session via ``Session(check=True)`` (or an explicit
:class:`Checker`); disabled by default with a one-branch hot-path cost, the
same contract as :mod:`repro_torch.core.telemetry`.

``lint`` is deliberately not imported here: it pulls in ``repro_torch.core``
and ``repro_torch.data`` lazily from inside the checker, keeping this package
importable from the core modules that embed the hooks.
"""

from repro_torch.check.checker import (CHECKING, Checker, NULL_CHECKER, armed_count,
                                       as_checker, reset)
from repro_torch.check.findings import CheckError, Finding

__all__ = ["CHECKING", "CheckError", "Checker", "Finding", "NULL_CHECKER",
           "armed_count", "as_checker", "reset"]
