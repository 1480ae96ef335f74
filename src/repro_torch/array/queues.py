"""NVMe-style submission/completion queue pairs for offload commands.

Mirrors the NVMe queueing model the paper's device sits behind: per-tenant
submission queues (SQs) with bounded depth, one completion queue (CQ) per
pair, and a weighted round-robin arbiter (the NVMe 'WRR with urgent priority'
arbitration mechanism, minus the urgent class) that decides which SQ the
device doorbell services next.

Backpressure is explicit: a full SQ either rejects the command
(``QueueFullError``, the NVMe 'queue full' status) or blocks the submitter
until the arbiter drains a slot, so one chatty tenant cannot starve the
device of queue slots.

Commands carry *verified* programs: the scheduler verifies before enqueue, so
everything past the SQ is admitted work (the same contract the paper's
verifier gives the single device). Since the completion-ring device model,
a command may instead carry a RAW I/O operation (``io_op`` = ``"read"`` /
``"append"``): the dispatcher forwards it to the array's submit path without
blocking and the completion arrives from the reactor — this is how checkpoint
save/restore rides the same queues (and the same WRR arbitration) as offload
traffic instead of issuing synchronous array calls.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np

from repro_torch.core.programs import Program
from repro_torch.telemetry.events import Severity as _Sev, publish as _publish_event
from repro_torch.telemetry.metrics import registry as _registry
from repro_torch.zns.ring import CompletionRing

# admission waits / WRR grant latencies above this are published as events
# (stall / starvation) on top of the always-on histograms — the operator
# signal that one tenant's backpressure turned pathological
STALL_EVENT_SECONDS = 0.25

__all__ = [
    "QueueFullError",
    "OffloadCommand",
    "Completion",
    "SubmissionQueue",
    "CompletionQueue",
    "QueuePair",
    "WeightedRoundRobinArbiter",
]


class QueueFullError(Exception):
    """Submission queue at depth limit (NVMe 'queue full' status)."""


_cmd_ids = itertools.count(1)


@dataclass
class OffloadCommand:
    """One verified submission (an NVMe command capsule analogue).

    Two shapes share the capsule: a verified offload (``program`` set,
    ``io_op`` None) executed by the scheduler's fan-out engine, or a raw I/O
    command (``program`` None, ``io_op`` = ``"read"``/``"append"``) the
    dispatcher forwards to the device's completion ring without blocking —
    ``data`` carries the append payload. ``on_complete`` (if set) receives
    the full :class:`Completion` when the command finishes, whichever thread
    retires it — the hook checkpoint tickets ride on.
    """

    program: Optional[Program]
    zone_id: int
    block_off: int
    n_blocks: Optional[int]
    tier: Optional[str]
    tenant: str = "default"
    cmd_id: int = field(default_factory=lambda: next(_cmd_ids))
    insns_verified: int = 0
    io_op: Optional[str] = None
    data: Optional[np.ndarray] = None
    # raw I/O only: target ONE array member instead of the logical array —
    # how rebuild/scrub traffic reaches an individual device while still
    # riding the tenant SQs and WRR arbitration
    member: Optional[int] = None
    on_complete: Optional[Callable[["Completion"], None]] = None
    # monotonic instant the command entered its SQ; the arbiter derives WRR
    # grant latency (SQ residency) from it
    submitted_at: float = 0.0


@dataclass
class Completion:
    """CQ entry: result (or error) + the aggregated stats for the command."""

    cmd_id: int
    tenant: str
    value: Any = None
    stats: Any = None
    error: Optional[BaseException] = None

    @property
    def ok(self) -> bool:
        return self.error is None


class SubmissionQueue:
    """Bounded FIFO of offload commands for one tenant."""

    def __init__(self, tenant: str, *, depth: int = 32, weight: int = 1):
        if depth <= 0:
            raise ValueError("queue depth must be positive")
        if weight <= 0:
            raise ValueError("arbitration weight must be positive")
        self.tenant = tenant
        self.depth = depth
        self.weight = weight
        self._q: deque[OffloadCommand] = deque()
        self._cond = threading.Condition()
        self.submitted = 0
        self.rejected = 0

    def submit(self, cmd: OffloadCommand, *, block: bool = False,
               timeout: Optional[float] = None) -> None:
        t0 = time.monotonic()
        deadline = None if timeout is None else t0 + timeout
        try:
            with self._cond:
                if len(self._q) >= self.depth and not block:
                    self.rejected += 1
                    raise QueueFullError(
                        f"SQ '{self.tenant}' full (depth={self.depth})")
                while len(self._q) >= self.depth:
                    # honour the TOTAL deadline across wakeups (a woken
                    # submitter may lose its slot to a rival and wait again)
                    remaining = None if deadline is None \
                        else deadline - time.monotonic()
                    if (remaining is not None and remaining <= 0) or \
                            not self._cond.wait(timeout=remaining):
                        self.rejected += 1
                        raise QueueFullError(
                            f"SQ '{self.tenant}' full after {timeout}s "
                            f"(depth={self.depth})")
                now = time.monotonic()
                cmd.submitted_at = now
                self._q.append(cmd)
                self.submitted += 1
        except QueueFullError as e:
            # outside the condition lock: event subscribers may themselves
            # touch the queues
            _publish_event(
                "sq.reject", severity=_Sev.WARNING, message=str(e),
                tenant=self.tenant, depth=self.depth)
            raise
        # admission wait = backpressure the submitter ate before its slot
        # opened (zero on the uncontended path); tenant names are a bounded
        # set, so per-tenant series live on the global registry
        wait = now - t0
        _registry().histogram(
            f"tenant.{self.tenant}.sq_admission_wait_seconds").observe(wait)
        if wait > STALL_EVENT_SECONDS:
            _publish_event(
                "sq.stall", severity=_Sev.WARNING,
                message=f"SQ '{self.tenant}' admission stalled "
                        f"{wait * 1e3:.0f}ms (depth={self.depth})",
                tenant=self.tenant, wait_s=wait, depth=self.depth)

    def pop(self) -> Optional[OffloadCommand]:
        with self._cond:
            if not self._q:
                return None
            cmd = self._q.popleft()
            self._cond.notify()  # free a slot for a blocked submitter
            return cmd

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)


class CompletionQueue(CompletionRing):
    """One tenant's fixed-depth ring of command completions (an NVMe CQ is a
    fixed-size ring: a host that does not keep up loses the oldest entries,
    counted in ``dropped``, rather than growing device memory without bound).
    The overwrite/accounting mechanics are the device layer's
    :class:`~repro_torch.zns.ring.CompletionRing` — one implementation for both
    the raw-transfer ring and the per-tenant command CQ."""

    def __init__(self, tenant: str, *, depth: int = 256):
        super().__init__(depth)
        self.tenant = tenant


@dataclass
class QueuePair:
    """One tenant's SQ/CQ pair (NVMe I/O queue pair analogue)."""

    sq: SubmissionQueue
    cq: CompletionQueue

    @property
    def tenant(self) -> str:
        return self.sq.tenant


class WeightedRoundRobinArbiter:
    """NVMe-style weighted round-robin over submission queues.

    Each round grants SQ ``i`` up to ``weight_i`` command slots; queues are
    serviced in order within the round, and empty queues forfeit their
    remaining credit. With every queue kept full, the dispatch mix converges
    to the weight ratio while staying work-conserving when queues run dry.
    """

    def __init__(self, pairs: Sequence[QueuePair] = ()):
        self._pairs: list[QueuePair] = list(pairs)
        self._lock = threading.Lock()
        self._credits: list[int] = [p.sq.weight for p in self._pairs]
        self._pos = 0

    def add(self, pair: QueuePair) -> None:
        with self._lock:
            self._pairs.append(pair)
            self._credits.append(pair.sq.weight)

    @property
    def pairs(self) -> list[QueuePair]:
        return list(self._pairs)

    def _refresh(self) -> None:
        self._credits = [p.sq.weight for p in self._pairs]

    def next_command(self) -> Optional[tuple[OffloadCommand, QueuePair]]:
        """Pop the next command per WRR policy, or None if every SQ is empty."""
        with self._lock:
            granted = self._next_locked()
        if granted is None:
            return None
        cmd, pair = granted
        # WRR grant latency: how long the command sat in its SQ before
        # arbitration granted it a slot; pathological residency (a starved
        # low-weight tenant behind heavy rivals) also surfaces as an event.
        # Metrics + events run outside the arbiter lock.
        wait = time.monotonic() - cmd.submitted_at
        _registry().histogram(
            f"tenant.{pair.tenant}.wrr_grant_seconds").observe(wait)
        if wait > STALL_EVENT_SECONDS:
            _publish_event(
                "wrr.starvation", severity=_Sev.WARNING,
                message=f"tenant '{pair.tenant}' command waited "
                        f"{wait * 1e3:.0f}ms for a WRR grant",
                tenant=pair.tenant, wait_s=wait)
        return cmd, pair

    def _next_locked(self) -> Optional[tuple[OffloadCommand, QueuePair]]:
        if not self._pairs:
            return None
        n = len(self._pairs)
        # at most two passes: one with current credits, one after refresh
        for _ in range(2):
            scanned = 0
            while scanned < n:
                i = self._pos
                pair, credit = self._pairs[i], self._credits[i]
                if credit > 0:
                    cmd = pair.sq.pop()
                    if cmd is not None:
                        self._credits[i] -= 1
                        if self._credits[i] == 0:
                            self._pos = (i + 1) % n
                        return cmd, pair
                # empty queue forfeits its credit for this round
                self._credits[i] = 0
                self._pos = (i + 1) % n
                scanned += 1
            self._refresh()
        return None
