"""Robustness subsystem: fault injection, invariant audit, degradation.

- :mod:`repro_torch.robust.faults`  — deterministic seeded fault injection
  (``REPRO_FAULTS`` env / :func:`faults.inject`) at named sites.
- :mod:`repro_torch.robust.audit`   — tiered invariant auditor
  (``REPRO_AUDIT``) + checksum bracketing of communication stages.
- :mod:`repro_torch.robust.deadline` — wall-time exchange deadlines
  (``REPRO_DEADLINE``), seeded retry backoff, and topology errors.
- :mod:`repro_torch.robust.recover` — degradation ladder and the
  :class:`~repro_torch.robust.recover.CheckpointedLoop`.

``faults``/``audit``/``deadline`` import nothing of ``core`` at module
scope, so ``repro_torch.core`` modules can hook them there; ``recover``
imports core inside its functions. On a grid every decision these modules
take (raise, retry, trip) is a collective one: every rank takes it or none
does.
"""
from . import audit, deadline, faults, recover
from .audit import AuditError
from .deadline import ExchangeGuard, ExchangeTimeout, TopologyError
from .faults import InjectedCrash
from .recover import LADDER, CheckpointedLoop

__all__ = ["audit", "deadline", "faults", "recover", "AuditError",
           "ExchangeGuard", "ExchangeTimeout", "TopologyError",
           "InjectedCrash", "LADDER", "CheckpointedLoop"]
