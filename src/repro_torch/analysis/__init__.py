"""Static verification of the port's plans (counterpart of
``repro.analysis``).

  * :mod:`repro_torch.analysis.plan_verify` — structural validator over
    every lowered :mod:`repro_torch.core.plan_ir` DAG.  ``Engine`` runs
    it on every lowered plan (``verify_plans=True``, the default) and
    ``plan_search`` on every candidate.
  * :mod:`repro_torch.analysis.kernel_check` — the runtime dispatch
    sanitizer ``Engine(sanitize=True)`` runs after each rule.
"""
from __future__ import annotations

from repro_torch.analysis.plan_verify import (PlanVerificationError,
                                              PlanViolation, assert_valid,
                                              verify_physical_plan)

__all__ = [
    "PlanVerificationError",
    "PlanViolation",
    "assert_valid",
    "verify_physical_plan",
]
