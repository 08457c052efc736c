"""Resilience: deterministic fault injection + end-to-end recovery.

Copy of ``deepspeed_tpu/resilience/__init__.py``. ``faults.py`` is the
chaos schedule; the recovery mechanics live where the state lives — in
the port, the serving front end's failure domain
(``serving/frontend.py``). This package is the injection/accounting spine.
"""

from deepspeed_tpu_torch.resilience.faults import (  # noqa: F401
    ACTION_KINDS, ADVISORY_KINDS, KINDS, SITES, TRIGGERS, FaultEntry,
    FaultInjector, InjectedEngineError, InjectedFault, InjectedIOError,
    fault_injector, parse_fault_plan, record_recovery)

__all__ = [
    "ACTION_KINDS", "ADVISORY_KINDS", "KINDS", "SITES", "TRIGGERS",
    "FaultEntry", "FaultInjector", "InjectedEngineError", "InjectedFault",
    "InjectedIOError", "fault_injector", "parse_fault_plan",
    "record_recovery",
]
