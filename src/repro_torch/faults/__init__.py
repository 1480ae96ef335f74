"""Deterministic fault injection and retry/timeout policy.

  * :mod:`repro_torch.faults.errors` — the transient taxonomy
    (:class:`TransientIOError` and friends), distinct from the permanent
    ``ZNSError`` family.
  * :mod:`repro_torch.faults.injector` — the seeded :class:`FaultInjector`
    consulted by device submit paths.
  * :mod:`repro_torch.faults.retry` — :class:`RetryPolicy` and the
    completion-callback retry controller.

The power-loss crash harness comes with the checkpoint slice of the port.
"""
from repro_torch.faults.errors import (IoTimeoutError, TornAppendError,
                                       TransientIOError)
from repro_torch.faults.injector import FaultDecision, FaultInjector, FaultSpec
from repro_torch.faults.retry import RetryPolicy, drive_retries, schedule_timer

__all__ = [
    "TransientIOError", "TornAppendError", "IoTimeoutError",
    "FaultInjector", "FaultSpec", "FaultDecision",
    "RetryPolicy", "drive_retries", "schedule_timer",
]
