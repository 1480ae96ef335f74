"""Deterministic fault injection, retry/timeout policy, and crash harness.

Everything the repo needs to emulate an *unreliable* ZNS fleet lives here:

  * :mod:`repro_torch.faults.errors` — the transient taxonomy
    (:class:`TransientIOError` and friends), distinct from the permanent
    ``ZNSError`` family.
  * :mod:`repro_torch.faults.injector` — the seeded :class:`FaultInjector`
    consulted by device submit paths; every schedule replays from a seed.
  * :mod:`repro_torch.faults.retry` — :class:`RetryPolicy` and the
    completion-callback retry controller (backoff in ring virtual time).
  * :mod:`repro_torch.faults.crash` — the power-loss crash harness for striped
    checkpoint saves. Imported lazily (it pulls in the checkpoint store,
    which pulls in the device layer): use
    ``from repro_torch.faults.crash import PowerLossHarness``.
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
