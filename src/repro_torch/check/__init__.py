"""step.check for the port: only the disabled surface exists so far."""

from repro_torch.check.checker import CHECKING, NULL_CHECKER, Checker, as_checker

__all__ = ["CHECKING", "NULL_CHECKER", "Checker", "as_checker"]
