"""Bounded, thread-safe structured event log — the fleet operator's journal.

Metrics answer "how much / how fast"; traces answer "where did the time go".
Neither answers "what *happened*": which zone went READ_ONLY, which member
died mid-append, which tenant's submissions stalled on a full SQ, which
checkpoint ticket failed and why. That is the event log's job — the
discrete, operator-facing record every layer publishes into:

  * zone state transitions to READ_ONLY / OFFLINE (:mod:`repro_torch.zns.device`);
  * member death, torn-append fencing and degraded reads
    (:mod:`repro_torch.array.striping`);
  * SQ admission stalls / rejections and WRR starvation
    (:mod:`repro_torch.array.queues`);
  * trace-ring and completion-ring overwrite drops;
  * checkpoint ticket failures (:mod:`repro_torch.train.checkpoint`);
  * health status changes and firing alerts
    (:mod:`repro_torch.telemetry.health` / :mod:`repro_torch.telemetry.alerts`).

Design constraints mirror the trace ring's: publishing must be cheap and can
never block or grow without bound — the log is a fixed-capacity ring (oldest
entries overwritten, counted in ``dropped``, exactly the CQ-overwrite
semantics the device layer already uses), one lock guards the ring, and
subscriber callbacks run OUTSIDE the lock with exceptions swallowed (a
consumer bug must not take down a publisher on the reactor or dispatcher
thread). Each event carries BOTH clocks the emulator runs on: ``t_mono``
(``time.monotonic()``, the virtual-time axis traces and device deadlines
share — events line up under a Chrome trace) and ``t_wall``
(``time.time()``, for humans and JSONL export).
"""
from __future__ import annotations

import enum
import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = [
    "Severity",
    "Event",
    "EventLog",
    "event_log",
    "publish",
]


class Severity(enum.IntEnum):
    """Syslog-shaped levels; ordered so ``>=`` filters work."""

    DEBUG = 10
    INFO = 20
    WARNING = 30
    ERROR = 40
    CRITICAL = 50


_seq = 0
_seq_lock = threading.Lock()


def _next_seq() -> int:
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


@dataclass(frozen=True)
class Event:
    """One structured record: a dotted ``name`` (``zone.offline``,
    ``alert.slo_breach``), a severity, free-form ``tags`` (device/zone/
    tenant/...), and both timestamps."""

    name: str
    severity: Severity
    message: str
    t_mono: float
    t_wall: float
    seq: int
    tags: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "name": self.name,
            "severity": self.severity.name,
            "message": self.message,
            "t_mono": self.t_mono,
            "t_wall": self.t_wall,
            "tags": self.tags,
        }


class EventLog:
    """Fixed-capacity ring of :class:`Event` records.

    ``publish`` is the single producer entry point (any thread);
    ``snapshot``/``tail`` read without consuming; ``export_jsonl`` writes one
    JSON object per line. ``subscribe`` registers a callback invoked with
    every published event — the alert engine's live feed — and returns an
    unsubscribe callable. Memory is bounded by construction: the ring
    overwrites oldest-first past ``capacity`` and counts the overwrites in
    ``dropped`` (asserted under sustained publishing by the telemetry tests).
    """

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError("event log capacity must be positive")
        self.capacity = capacity
        self._q: deque[Event] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._subscribers: list[Callable[[Event], None]] = []
        self.published = 0
        self.dropped = 0

    # -------------------------------------------------------------- produce
    def publish(self, name: str, *, severity: Severity = Severity.INFO,
                message: str = "", **tags) -> Event:
        ev = Event(name=name, severity=Severity(severity), message=message,
                   t_mono=time.monotonic(), t_wall=time.time(),
                   seq=_next_seq(), tags=tags)
        with self._lock:
            if len(self._q) == self._q.maxlen:
                self.dropped += 1
            self._q.append(ev)
            self.published += 1
            subs = list(self._subscribers)
        for fn in subs:                 # outside the lock, failures isolated
            try:
                fn(ev)
            except Exception:
                pass
        return ev

    # ------------------------------------------------------------- consume
    def subscribe(self, fn: Callable[[Event], None]) -> Callable[[], None]:
        """Register ``fn(event)`` for every future publish; returns an
        unsubscribe callable (idempotent)."""
        with self._lock:
            self._subscribers.append(fn)

        def unsubscribe() -> None:
            with self._lock:
                if fn in self._subscribers:
                    self._subscribers.remove(fn)

        return unsubscribe

    def snapshot(self, *, min_severity: Severity = Severity.DEBUG,
                 name: Optional[str] = None,
                 since_seq: int = 0) -> list[Event]:
        """Non-consuming filtered view, oldest-first. ``name`` matches exact
        names or dotted prefixes (``"zone"`` matches ``"zone.offline"``);
        ``since_seq`` skips events at or below a previously-seen sequence
        number (the incremental-poll idiom the alert engine uses)."""
        with self._lock:
            evs = list(self._q)
        out = []
        for e in evs:
            if e.severity < min_severity or e.seq <= since_seq:
                continue
            if name is not None and e.name != name and \
                    not e.name.startswith(name + "."):
                continue
            out.append(e)
        return out

    def tail(self, n: int = 10) -> list[Event]:
        with self._lock:
            evs = list(self._q)
        return evs[-n:]

    def last_seq(self) -> int:
        with self._lock:
            return self._q[-1].seq if self._q else 0

    def clear(self) -> None:
        with self._lock:
            self._q.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    # -------------------------------------------------------------- export
    def export_jsonl(self, path: str) -> int:
        """Write the current ring as JSON Lines (one event object per line,
        oldest-first). Returns the number of events written."""
        evs = self.snapshot()
        with open(path, "w") as f:
            for e in evs:
                f.write(json.dumps(e.to_dict()) + "\n")
        return len(evs)


_global: Optional[EventLog] = None
_global_lock = threading.Lock()


def event_log() -> EventLog:
    """The process-wide event log every instrumented layer publishes into
    (the analogue of :func:`repro_torch.telemetry.metrics.registry`)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = EventLog()
        return _global


def publish(name: str, *, severity: Severity = Severity.INFO,
            message: str = "", **tags) -> Event:
    """Publish to the global log — the one-liner instrumented layers use."""
    return event_log().publish(name, severity=severity, message=message,
                               **tags)
