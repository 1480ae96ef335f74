"""Async completion-ring device model: one reactor drives all in-flight I/O.

The paper's ZCSD sits behind an NVMe-style asynchronous submission/completion
interface; real ZNS hardware sustains throughput by keeping MANY transfers in
flight per device (arXiv:2010.06243 characterizes intra-device queue-depth
scaling). The previous emulation modelled transfer time with a per-transfer
``time.sleep`` — every in-flight read burned a worker thread, so array fan-out
concurrency was bounded by pool size, not by the emulated device parallelism.

This module replaces thread-per-transfer blocking with an event-loop model:

  * :class:`IoFuture` — one in-flight transfer descriptor + completion
    rendezvous (the NVMe command/CQE pair). The data effect (buffer slice,
    write-pointer advance) happens synchronously at submission under the
    device lock, exactly as before; only the *timing* — when the completion
    is visible — is deferred to the emulated deadline.
  * :class:`IoReactor` — a single daemon thread holding a deadline-ordered
    heap of in-flight futures. It sleeps until the earliest deadline and
    retires everything due, like an NVMe controller posting CQEs: one thread
    drives hundreds of in-flight transfers.
  * :class:`CompletionRing` — a bounded MPSC ring a submitter may attach to
    its futures; retired completions land there in retirement order (the
    host-visible CQ analogue, with ring-overwrite ``dropped`` accounting).

Per-zone serialization (one flash die per zone) is preserved by the devices
through *virtual-time queues*: each zone tracks ``io_busy_until``, and a new
transfer's deadline is ``max(now, busy_until) + service``; the zone's clock
advances to that deadline. Transfers against one zone retire strictly in
submission order; transfers against different zones overlap — the same
semantics the old per-zone ``io_gate`` sleeps enforced, minus the threads.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Callable, Optional

from repro_torch.telemetry import metrics as _metrics
from repro_torch.telemetry.events import Severity as _Sev, publish as _publish_event

__all__ = ["IoFuture", "IoReactor", "CompletionRing", "CompletionBarrier",
           "in_reactor_thread"]

# One lock serializes completion/callback transitions for ALL futures. The
# critical sections are a few pointer moves, and a shared lock keeps IoFuture
# allocation-free on the inline-completion fast path (no per-future Event
# unless somebody actually blocks on a timed transfer).
_TRANSITION_LOCK = threading.Lock()

# Set inside every reactor loop thread: lets completion consumers route heavy
# callback work (gather memcpys) off the pump precisely, instead of guessing
# from submission phase.
_IN_REACTOR = threading.local()


def in_reactor_thread() -> bool:
    """True when the calling thread is an IoReactor completion pump."""
    return getattr(_IN_REACTOR, "active", False)

_seq = itertools.count(1)


class IoFuture:
    """One submitted I/O: descriptor fields + a completion rendezvous.

    ``value``/``error`` become readable once :meth:`done` — for reads the
    value is the device buffer view (or copy) snapshotted at submission (zones
    are append-only, so the bytes cannot change underneath a legal host);
    for appends it is the landing block, which real ZNS Zone Append also only
    reports in the completion entry.
    """

    __slots__ = ("op", "zone_id", "block_off", "nblocks", "service_seconds",
                 "deadline", "seq", "submitted_block", "ring", "device",
                 "tenant", "waits_on", "_prev", "_value", "_error", "_done",
                 "_event", "_callbacks", "__weakref__")

    def __init__(self, op: str = "io", zone_id: int = -1, block_off: int = 0,
                 nblocks: int = 0, service_seconds: float = 0.0,
                 ring: Optional["CompletionRing"] = None):
        self.op = op
        self.zone_id = zone_id
        self.block_off = block_off
        self.nblocks = nblocks
        self.service_seconds = service_seconds
        self.deadline = 0.0
        self.seq = next(_seq)
        self.submitted_block: Optional[int] = None
        self.ring = ring
        # stuck-op diagnostics: who owns this transfer and what it fans out
        # to — ``result(timeout=)`` names them instead of timing out mutely
        self.device: str = ""
        self.tenant: Optional[str] = None
        self.waits_on: Optional[list] = None   # member futures of a fan-out
        # the zone's previous timed transfer (completion-order chain): an
        # already-due future may only retire inline if its predecessor has
        # retired — otherwise it parks in the reactor heap, whose
        # (deadline, seq) order preserves the per-zone sequence
        self._prev: Optional["IoFuture"] = None
        self._value = None
        self._error: Optional[BaseException] = None
        self._done = False
        self._event: Optional[threading.Event] = None
        self._callbacks: list[Callable[["IoFuture"], None]] = []

    # ------------------------------------------------------------- consumers
    def done(self) -> bool:
        return self._done

    @property
    def value(self):
        """The completed value (None until :meth:`done`; raises if errored)."""
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def stuck_detail(self) -> str:
        """One-line diagnosis of an overdue transfer: op, device, zone,
        owning tenant, and — for a fan-out aggregate — the first member
        transfer still holding it up (a hung command names itself)."""
        where = f" on {self.device}" if self.device else ""
        who = f" for tenant {self.tenant!r}" if self.tenant else ""
        msg = f"{self.op}{where} zone {self.zone_id}{who} still in flight"
        for m in (self.waits_on or ()):
            if not m.done():
                msg += (f" (waiting on {m.op} {m.device or '?'} "
                        f"zone {m.zone_id} seq #{m.seq})")
                break
        return msg

    def result(self, timeout: Optional[float] = None):
        """Block until the emulated completion deadline; return the value or
        re-raise the transfer's error. ``timeout`` bounds the wait in wall
        seconds — on expiry a ``TimeoutError`` names the stuck op
        (device/zone/op/tenant) instead of hanging the caller forever."""
        if not self._done:
            with _TRANSITION_LOCK:
                if not self._done and self._event is None:
                    self._event = threading.Event()
                ev = self._event
            if ev is not None and not ev.wait(timeout):
                raise TimeoutError(self.stuck_detail())
        if self._error is not None:
            raise self._error
        return self._value

    def add_done_callback(self, fn: Callable[["IoFuture"], None]) -> None:
        """Run ``fn(self)`` when the completion retires (immediately if it
        already has). Callback exceptions are swallowed, as with
        ``concurrent.futures`` — a completion consumer must not be able to
        kill the reactor."""
        with _TRANSITION_LOCK:
            if not self._done:
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    # ------------------------------------------------------------- producers
    def complete(self, value=None) -> "IoFuture":
        self._value = value
        self._retire()
        return self

    def fail(self, error: BaseException) -> "IoFuture":
        self._error = error
        self._retire()
        return self

    def _retire(self) -> None:
        with _TRANSITION_LOCK:
            if self._done:
                raise RuntimeError(f"completion {self.seq} retired twice")
            self._done = True
            self._prev = None          # release the per-zone chain for GC
            cbs, self._callbacks = self._callbacks, []
            ev = self._event
        if ev is not None:
            ev.set()
        if self.ring is not None:
            self.ring.push(self)
        for fn in cbs:
            self._run_callback(fn)

    def _run_callback(self, fn) -> None:
        try:
            fn(self)
        except Exception:
            pass  # a consumer bug must not take down the reactor thread

    def __repr__(self) -> str:
        state = "done" if self._done else "in-flight"
        return (f"IoFuture(#{self.seq} {self.op} zone={self.zone_id} "
                f"[{self.block_off},+{self.nblocks}) {state})")


class CompletionBarrier:
    """Fan-in join over ``n`` completions settled from arbitrary threads.

    Collects per-slot values, latches the FIRST error, and fires
    ``on_done(values, error)`` exactly once when the last slot settles — the
    one barrier shape shared by the striped array's member fan-out and the
    checkpoint store's leaf fan-out. An ``n`` of zero fires ``on_done``
    immediately (from the constructor)."""

    def __init__(self, n: int,
                 on_done: Callable[[list, Optional[BaseException]], None]):
        self.values: list = [None] * n
        self._remaining = n
        self._error: Optional[BaseException] = None
        self._on_done = on_done
        self._lock = threading.Lock()
        if n == 0:
            on_done(self.values, None)

    def settle(self, i: int, error: Optional[BaseException] = None,
               value=None) -> None:
        with self._lock:
            if error is not None:
                if self._error is None:
                    self._error = error
            else:
                self.values[i] = value
            self._remaining -= 1
            last = self._remaining == 0
        if last:
            self._on_done(self.values, self._error)


class CompletionRing:
    """Bounded MPSC ring of retired completion entries (NVMe CQ analogue): a
    host that does not keep up loses the oldest entries (counted in
    ``dropped``) rather than growing without bound.

    Entry-type agnostic — the device layer rings :class:`IoFuture`
    descriptors through it and the array layer's per-tenant
    ``CompletionQueue`` subclasses it for command completions, so the
    overwrite/accounting semantics live in exactly one place.
    """

    def __init__(self, depth: int = 256):
        if depth <= 0:
            raise ValueError("ring depth must be positive")
        self.depth = depth
        self._q: deque = deque(maxlen=depth)
        self._cond = threading.Condition()
        self.dropped = 0
        self.retired = 0

    def push(self, entry) -> None:
        with self._cond:
            first_drop = False
            if len(self._q) == self.depth:
                if self.dropped == 0:
                    first_drop = True
                self.dropped += 1          # ring overwrite of the oldest CQE
            self._q.append(entry)
            self.retired += 1
            self._cond.notify_all()
        if first_drop:
            # one event per ring lifetime, outside the lock (push may run on
            # the reactor thread); ``dropped`` counts the rest
            _publish_event(
                "ring.cq_drop", severity=_Sev.WARNING,
                message=f"completion ring depth={self.depth} overwrote its "
                        "oldest entry (host not keeping up)",
                depth=self.depth)

    def pop(self, *, timeout: Optional[float] = None):
        with self._cond:
            if not self._q and timeout is not None:
                self._cond.wait(timeout=timeout)
            return self._q.popleft() if self._q else None

    def drain(self) -> list:
        with self._cond:
            out = list(self._q)
            self._q.clear()
            return out

    def wait_retired(self, n: int, *, timeout: Optional[float] = None) -> bool:
        """Block until ``n`` completions have retired into this ring over its
        lifetime (drops count — they retired, the host just lost the entry)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self.retired < n:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
            return True

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)


class IoReactor:
    """Deadline-ordered completion pump: ONE thread retires every in-flight
    emulated transfer, however many devices share it.

    Futures whose deadline has already passed at scheduling time complete
    inline on the submitter thread (a zero-service transfer on an idle zone —
    the non-emulated fast path pays no thread hop and no allocation beyond
    the future itself). Everything else parks in a heap; the reactor sleeps
    until the earliest deadline and retires all due completions, in deadline
    order with submission sequence as the tiebreak.
    """

    _default: Optional["IoReactor"] = None
    _default_lock = threading.Lock()

    def __init__(self, name: str = "zns-io-reactor"):
        self.name = name
        self._heap: list[tuple[float, int, IoFuture]] = []
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        # host-visible counters: proof of in-flight depth for the benchmarks
        self.retired = 0
        self.max_in_flight = 0

    @classmethod
    def default(cls) -> "IoReactor":
        """The process-wide shared reactor (devices default to it, so one
        thread drives all in-flight I/O of every emulated device)."""
        with cls._default_lock:
            if cls._default is None:
                cls._default = cls()
                # the default reactor is THE process-wide pump — surface its
                # occupancy in the global metrics snapshot
                r = cls._default
                _metrics.registry().register_collector("reactor", lambda: {
                    "in_flight": r.in_flight,
                    "max_in_flight": r.max_in_flight,
                    "retired": r.retired,
                })
            return cls._default

    @property
    def in_flight(self) -> int:
        with self._cond:
            return len(self._heap)

    # ------------------------------------------------------------ scheduling
    def schedule(self, fut: IoFuture, deadline: float) -> IoFuture:
        """Arm ``fut`` to retire at monotonic time ``deadline`` (value/error
        must already be staged via ``fut._value``/``complete`` by the caller
        side — see the device submit paths)."""
        fut.deadline = deadline
        prev = fut._prev
        if deadline <= time.monotonic() and (prev is None or prev._done):
            # already due AND no in-flight predecessor on this zone: retire
            # on the submitter thread (the non-emulated fast path)
            fut._retire()
            return fut
        with self._cond:
            if self._stopped:
                raise RuntimeError(f"reactor {self.name} is closed")
            heapq.heappush(self._heap, (deadline, fut.seq, fut))
            if len(self._heap) > self.max_in_flight:
                self.max_in_flight = len(self._heap)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name=self.name, daemon=True)
                self._thread.start()
            self._cond.notify()
        return fut

    def _run(self) -> None:
        _IN_REACTOR.active = True
        while True:
            due: list[IoFuture] = []
            with self._cond:
                if self._stopped and not self._heap:
                    return
                now = time.monotonic()
                while self._heap and self._heap[0][0] <= now:
                    _, seq, fut = heapq.heappop(self._heap)
                    prev = fut._prev
                    if prev is not None and not prev._done:
                        # the zone's predecessor transfer has not retired —
                        # it was claimed before this one but may not have
                        # reached the heap yet (claim and schedule are not
                        # atomic). Defer briefly; the chain is acyclic, so
                        # this always makes progress.
                        heapq.heappush(self._heap, (now + 5e-5, seq, fut))
                        continue
                    due.append(fut)
                if not due:
                    wait = self._heap[0][0] - now if self._heap else None
                    self._cond.wait(timeout=wait)
                    continue
                self.retired += len(due)
            # Deadline slip = how late the pump retired each completion past
            # its emulated deadline — the reactor's own serialization signal.
            # Fetched per batch (not cached) so a registry reset in tests
            # cannot orphan the series.
            h = _metrics.registry().histogram("reactor.slip_seconds")
            for fut in due:
                h.observe(now - fut.deadline)
            for fut in due:           # outside the lock: callbacks may submit
                fut._retire()

    def close(self) -> None:
        """Drain and stop the reactor thread (in-flight completions still
        retire at their deadlines first)."""
        with self._cond:
            self._stopped = True
            self._cond.notify()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=10.0)
