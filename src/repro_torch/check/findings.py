"""Shared findings/report model for step.check (port of :mod:`repro.check.findings`).

All three analysis layers (races / locks / lint) report through one shape: a
:class:`Finding` names the layer that produced it, a stable ``kind`` slug, a
severity, the DSM name involved (when there is one), the source locations of
the offending accesses, and the STEP thread ids.  The checker dedupes on
``Finding.key()`` so a racy loop reports each distinct (kind, name, sites)
pair once, not once per iteration.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

#: severity levels, in increasing order of badness
SEVERITIES = ("warning", "error")

#: the analysis layer a finding came from
LAYERS = ("race", "lock", "lint")


class CheckError(RuntimeError):
    """Raised by a strict checker when the lint pass finds error-severity
    hazards at spawn time — before any thread has started running."""

    def __init__(self, findings):
        self.findings = list(findings)
        lines = "\n".join(f"  - {f.message}" for f in self.findings)
        super().__init__(
            f"step.check rejected the program ({len(self.findings)} "
            f"error finding(s)):\n{lines}")


@dataclass(frozen=True)
class Finding:
    """One correctness hazard, in the shape shared by all three layers."""

    layer: str                       # "race" | "lock" | "lint"
    kind: str                        # stable slug, e.g. "write-write"
    severity: str                    # "warning" | "error"
    message: str                     # human-readable, names both sites
    name: Optional[str] = None       # DSM name involved, if any
    sites: Tuple[str, ...] = ()      # "file:line" source locations
    tids: Tuple[Any, ...] = ()       # STEP thread ids involved

    def key(self) -> tuple:
        """Dedupe identity: the same hazard found again (another loop
        iteration, another round) collapses onto one finding."""
        return (self.layer, self.kind, self.name, self.sites, self.tids)

    def as_dict(self) -> Dict[str, Any]:
        return {"layer": self.layer, "kind": self.kind,
                "severity": self.severity, "message": self.message,
                "name": self.name, "sites": list(self.sites),
                "tids": [str(t) for t in self.tids]}


# the port's own framework directories: a finding must point past them
_INTERNAL = (os.sep + os.path.join("repro_torch", "core") + os.sep,
             os.sep + os.path.join("repro_torch", "check") + os.sep)


def call_site(extra_skip: int = 0) -> str:
    """The first stack frame *outside* repro_torch.core/repro_torch.check, as
    ``file:line`` — the access site a finding should point the user at.

    Hooks sit inside the framework, so the interesting frame is the caller's
    ``ref.get()`` / ``barrier.enter()`` line in user code (or a test).  Falls
    back to the outermost frame when every frame is internal (e.g. an
    accumulator round closing deep inside the framework)."""
    frame = sys._getframe(2 + extra_skip)
    last = None
    while frame is not None:
        fn = frame.f_code.co_filename
        last = f"{fn}:{frame.f_lineno}"
        if not any(part in fn for part in _INTERNAL):
            return last
        frame = frame.f_back
    return last or "<unknown>"
