"""Transient-error taxonomy for the fault-injection subsystem.

The existing :class:`~repro_torch.zns.device.ZNSError` family models *protocol*
violations and *permanent* failures: a read past the write pointer, an
append to a FULL zone, an OFFLINE member. Real ZNS devices additionally
return transient NVMe statuses — media errors that succeed on retry,
commands that exceed their latency budget, appends whose payload only
partially reached the media (the anomalies arXiv:2010.06243 documents on
production hardware). Those deserve a *distinct* taxonomy: a caller that
treats a retryable media error like a dead zone amputates members it could
have ridden through.

Every class here is an **error completion**, not a submit-time exception:
the device stages it on the transfer's :class:`~repro_torch.zns.ring.IoFuture`
and the completion ring delivers it at the emulated deadline, exactly like
a late NVMe CQE with a non-success status code.

``retryable`` is the one bit the retry engine consults: media errors and
timeouts are worth another attempt, a torn append is not (the zone's write
pointer is indeterminate — the host must fence and recover, as on real
hardware).
"""
from __future__ import annotations

__all__ = ["TransientIOError", "TornAppendError", "IoTimeoutError"]


class TransientIOError(Exception):
    """A transient device-level I/O failure delivered via the completion
    ring (retryable NVMe status analogue). NOT a :class:`ZNSError` — the
    protocol was honored; the media/transport hiccuped."""

    kind = "media"
    retryable = True

    def __init__(self, message: str, *, op: str = "io", device: str = "",
                 zone_id: int = -1, attempt: int = 1):
        super().__init__(message)
        self.op = op
        self.device = device
        self.zone_id = zone_id
        self.attempt = attempt


class TornAppendError(TransientIOError):
    """An append whose payload only partially reached the media before the
    command failed: the zone's write pointer is indeterminate past the last
    durable block. Non-retryable — blindly re-appending would interleave
    garbage into the stripe stream; the owner must fence the zone."""

    kind = "torn_append"
    retryable = False


class IoTimeoutError(TransientIOError):
    """A command that exceeded its per-op timeout budget (either a hung
    command whose completion never arrived, or a latency spike past the
    policy's patience). Raised to the caller only after the retry budget is
    exhausted."""

    kind = "timeout"
