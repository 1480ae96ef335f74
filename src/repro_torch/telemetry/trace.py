"""Span tracing on wall time *and* reactor virtual time.

The reactor emulates device latency on a virtual timeline (``io_busy_until``
deadlines measured on ``time.monotonic()``), while the Python host threads —
dispatcher, gather pool, reactor pump — burn real wall time on the same
clock. A profile of the array fan-out is only legible if both kinds of
activity land on ONE timeline, so every event here carries
``time.monotonic()`` timestamps: host spans sample the clock around their
body; device-side "virtual" events are emitted post-hoc from the claimed
``(start, service)`` windows via :func:`event_complete`.

Design constraints from the hot path:

  * **near-zero disabled cost** — ``span()`` checks one module-level bool
    and returns a shared no-op singleton whose ``__enter__``/``__exit__``
    do nothing; no allocation, no lock, no clock read.
  * **lock-light enabled path** — each thread appends into its own
    preallocated ring buffer (a plain-list ring; the only global lock is
    taken once per thread at buffer registration). Overflow overwrites the
    oldest events and counts drops — tracing must never stall the reactor.
  * **nesting without frames** — a contextvar stack carries the parent
    span's tags, so a ``stage.read_wait`` span inside ``offload.execute``
    inherits tenant/device tags it never set; contextvars also follow the
    code into coroutine-style callbacks better than thread-locals would.

Two kinds of event come from the tracer itself while it is on:

  * ``py.gc`` — each pass of Python's cyclic collector, as a complete
    event tagged ``generation`` and ``collected`` (and the tags of the span
    it interrupted), through one ``gc.callbacks`` entry registered when
    tracing turns on and removed when it turns off.
  * ``trace.clock`` — a zero-duration anchor as tracing turns on and again
    as it turns off, tagged ``unix_ns``: ``time.time_ns()`` read beside the
    ``time.monotonic()`` that is its ``ts``. ``torch.profiler`` stamps its
    events in Unix time, so the two anchors put every span on the
    profiler's timeline (``base_ns`` of :func:`to_chrome_events`).

Export is Chrome ``trace_event`` JSON (``{"traceEvents": [...]}``) with
complete ("ph": "X") events: load it in Perfetto / chrome://tracing. Host
threads render as pid 1 (one row per thread); device virtual tracks as
pid 2 (one row per ``track=`` name, e.g. ``dev0/zone3``).
"""
from __future__ import annotations

import gc
import json
import threading
import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Optional

__all__ = [
    "set_enabled",
    "enabled",
    "tracing",
    "span",
    "instant",
    "event_complete",
    "drain",
    "clear",
    "dropped",
    "export_chrome",
    "to_chrome_events",
    "complete",
    "RING_CAPACITY",
]

RING_CAPACITY = 65536  # events per thread before overwrite

_enabled = False

# Every registered per-thread ring, so drain() can see them all. Entries are
# _Ring objects; rings of dead threads stay until clear() — their events are
# part of the trace.
_rings_lock = threading.Lock()
_rings: list["_Ring"] = []
_local = threading.local()

# (name, tags) of the innermost live span — children inherit tags from it.
_span_ctx: ContextVar[Optional[tuple[str, dict]]] = ContextVar(
    "repro_trace_span", default=None)


def set_enabled(on: bool) -> None:
    """Turn tracing on or off. Each turn records a ``trace.clock`` anchor
    (the closing one before the flag drops) and adds or removes the
    collector's callback."""
    global _enabled
    on = bool(on)
    if on == _enabled:
        return
    if on:
        _enabled = True
        gc.callbacks.append(_on_gc)
        _clock_anchor()
    else:
        _clock_anchor()
        if _on_gc in gc.callbacks:
            gc.callbacks.remove(_on_gc)
        _enabled = False


def enabled() -> bool:
    return _enabled


@contextmanager
def tracing(on: bool = True):
    """Temporarily flip tracing (benchmarks wrap their measured region)."""
    prev = _enabled
    set_enabled(on)
    try:
        yield
    finally:
        set_enabled(prev)


class _Ring:
    """Single-writer event ring. Only its owning thread appends; drain()
    reads concurrently, which is safe for a stats ring (a torn read of the
    slot being overwritten is the worst case, and drain is a debugging/export
    operation, not a correctness path)."""

    __slots__ = ("tid", "tname", "buf", "head", "dropped")

    def __init__(self, tid: int, tname: str):
        self.tid = tid
        self.tname = tname
        self.buf: list = [None] * RING_CAPACITY
        self.head = 0      # next write index (monotonic, wraps via modulo)
        self.dropped = 0   # events overwritten after the ring first filled

    def append(self, ev: tuple) -> None:
        h = self.head
        if h >= RING_CAPACITY and self.buf[h % RING_CAPACITY] is not None:
            self.dropped += 1
            if self.dropped == 1:
                # cold path, once per ring lifetime: tell the event log the
                # exported trace will be incomplete for this thread. Imported
                # lazily — the hot append path must stay import-free.
                from .events import Severity, publish
                publish("trace.ring_drop", severity=Severity.WARNING,
                        message=f"trace ring for thread {self.tname!r} "
                                f"wrapped (capacity {RING_CAPACITY})",
                        thread=self.tname, capacity=RING_CAPACITY)
        self.buf[h % RING_CAPACITY] = ev
        self.head = h + 1

    def events(self) -> list:
        h = self.head
        if h <= RING_CAPACITY:
            return [e for e in self.buf[:h] if e is not None]
        i = h % RING_CAPACITY
        return [e for e in self.buf[i:] + self.buf[:i] if e is not None]


def _ring() -> _Ring:
    r = getattr(_local, "ring", None)
    if r is None:
        t = threading.current_thread()
        r = _Ring(t.ident or 0, t.name)
        _local.ring = r
        with _rings_lock:
            _rings.append(r)
    return r


# Event tuples: ("X", name, ts, dur, tid_or_track, tags) for complete events
# (tid_or_track is None → host thread row; a string → device virtual track),
# ("I", name, ts, tags) for instants.


class _Span:
    """A live span: records (ts, dur) around its body and pushes itself as
    the contextvar parent so children inherit its tags."""

    __slots__ = ("name", "tags", "_t0", "_token")

    def __init__(self, name: str, tags: dict):
        self.name = name
        self.tags = tags
        self._t0 = 0.0
        self._token = None

    def __enter__(self):
        self._token = _span_ctx.set((self.name, self.tags))
        self._t0 = time.monotonic()
        return self

    def tag(self, **tags) -> None:
        """Add tags to the open span; spans opened inside it from now on
        inherit them."""
        self.tags.update(tags)

    def __exit__(self, *exc):
        dur = time.monotonic() - self._t0
        if self._token is not None:
            _span_ctx.reset(self._token)
        _ring().append(("X", self.name, self._t0, dur, None, self.tags))
        return False


class _NoopSpan:
    """Shared singleton returned when tracing is off — the entire disabled
    cost of ``with span(...)`` is one bool test plus two empty methods."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def span(name: str, **tags):
    """Context manager timing its body. Tags (tenant/device/zone/tier/op)
    merge over the enclosing span's tags."""
    if not _enabled:
        return _NOOP
    parent = _span_ctx.get()
    if parent is not None and parent[1]:
        merged = dict(parent[1])
        merged.update(tags)
        tags = merged
    return _Span(name, tags)


def complete(name: str, t0: float, **tags) -> float:
    """Record a span ``name`` from ``t0`` (a ``time.monotonic()`` read) to
    now, its tags merged over the enclosing span's as :func:`span` does, and
    return now, the next step's start. For hot paths that read the flag once
    and test it themselves: ``if traced: t = trace.complete("step", t)``
    costs nothing untraced, where a ``with`` block costs two calls."""
    now = time.monotonic()
    if _enabled:
        _ring().append(("X", name, t0, now - t0, None, _inherit(tags)))
    return now


def _inherit(tags: dict) -> dict:
    """``tags`` merged over the enclosing span's, as :func:`span` does."""
    parent = _span_ctx.get()
    if parent is None or not parent[1]:
        return tags
    return {**parent[1], **tags}


def instant(name: str, **tags) -> None:
    """Zero-duration marker at now."""
    if not _enabled:
        return
    _ring().append(("I", name, time.monotonic(), tags))


def event_complete(name: str, ts: float, dur: float,
                   track: Optional[str] = None, **tags) -> None:
    """Record a complete event with EXPLICIT timestamps — how device virtual
    time enters the trace. The device model knows each transfer's claimed
    ``(start, service)`` window on the monotonic clock before it elapses;
    it calls this at submit time with ``track="dev0/zone3"`` and the event
    lands on that device row rather than the submitting thread's row."""
    if not _enabled:
        return
    _ring().append(("X", name, ts, dur, track, tags))


_ANCHOR_READS = 5
_gc_t0: Optional[float] = None   # start of the collection in progress


def _clock_anchor() -> None:
    """Record ``trace.clock``: the closest of a few (monotonic, Unix)
    pairs, its ``ts`` the middle of the two monotonic reads around the
    Unix one."""
    best = None
    for _ in range(_ANCHOR_READS):
        a = time.monotonic()
        unix_ns = time.time_ns()
        b = time.monotonic()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) / 2, unix_ns)
    _ring().append(("X", "trace.clock", best[1], 0.0, None,
                    {"unix_ns": best[2]}))


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: one ``py.gc`` event a collection, on the
    thread that triggered it (collections do not nest)."""
    global _gc_t0
    if phase == "start":
        _gc_t0 = time.monotonic()
        return
    t0, _gc_t0 = _gc_t0, None
    if t0 is None or not _enabled:
        return
    tags = {"generation": info["generation"], "collected": info["collected"]}
    _ring().append(("X", "py.gc", t0, time.monotonic() - t0, None,
                    _inherit(tags)))


def dropped() -> int:
    with _rings_lock:
        return sum(r.dropped for r in _rings)


def drain() -> list[dict]:
    """Snapshot all recorded events as dicts (wall seconds), oldest-first
    per thread. Does not clear — export after a run, then :func:`clear`."""
    with _rings_lock:
        rings = list(_rings)
    out = []
    for r in rings:
        for ev in r.events():
            if ev[0] == "X":
                _, name, ts, dur, track, tags = ev
                out.append({"type": "span", "name": name, "ts": ts,
                            "dur": dur, "track": track,
                            "tid": r.tid, "thread": r.tname, "tags": tags})
            else:
                _, name, ts, tags = ev
                out.append({"type": "instant", "name": name, "ts": ts,
                            "tid": r.tid, "thread": r.tname, "tags": tags})
    out.sort(key=lambda e: e["ts"])
    return out


def clear() -> None:
    """Drop all recorded events and rings (fresh trace)."""
    with _rings_lock:
        _rings.clear()
    # Threads re-register on next append; stale thread-local rings are
    # detached from _rings so their future events are invisible — replace
    # the current thread's ring eagerly since it is the common writer.
    _local.ring = None


_HOST_PID = 1
_DEVICE_PID = 2


def _profiler_axis(events: list[dict], base_ns: int):
    """``(ts_us, scale)``: the map of a monotonic ``ts`` onto a profiler
    trace's axis (µs after ``base_ns``, Kineto's ``baseTimeNanoseconds``),
    linear through the first and last ``trace.clock`` anchors, and the
    factor that takes a duration in seconds to µs on it."""
    anchors = sorted((e["ts"], e["tags"]["unix_ns"]) for e in events
                     if e["type"] == "span" and e["name"] == "trace.clock")
    if not anchors:
        raise ValueError("no trace.clock anchor among the events: they were "
                         "not recorded by set_enabled")
    (m0, u0), (m1, u1) = anchors[0], anchors[-1]
    ns_per_s = (u1 - u0) / (m1 - m0) if m1 > m0 else 1e9
    lead_ns = u0 - int(base_ns)          # exact in ints; floats only for ts - m0
    return (lambda ts: (lead_ns + (ts - m0) * ns_per_s) * 1e-3), ns_per_s * 1e-3


def to_chrome_events(events: Optional[list[dict]] = None,
                     base_ns: Optional[int] = None) -> list[dict]:
    """Convert drained events to Chrome ``trace_event`` dicts (ts/dur in µs,
    rebased so the trace starts near 0). Given ``base_ns``, the
    ``baseTimeNanoseconds`` of a ``torch.profiler`` Chrome trace, each
    ``ts`` lands on that trace's axis instead (µs after ``base_ns``, through
    the ``trace.clock`` anchors), so both load aligned in Perfetto."""
    if events is None:
        events = drain()
    if not events:
        return []
    if base_ns is None:
        t0 = min(e["ts"] for e in events)
        to_us, scale = (lambda ts: (ts - t0) * 1e6), 1e6
    else:
        to_us, scale = _profiler_axis(events, base_ns)
    out: list[dict] = []
    # Metadata: name host threads; give each device track its own tid row.
    threads_seen: dict[int, str] = {}
    tracks: dict[str, int] = {}
    body: list[dict] = []
    for e in events:
        ts_us = to_us(e["ts"])
        args = dict(e["tags"]) if e["tags"] else {}
        if e["type"] == "span" or e.get("track"):
            track = e.get("track")
            if track is not None:
                tid = tracks.setdefault(track, len(tracks) + 1)
                pid = _DEVICE_PID
            else:
                tid = e["tid"]
                pid = _HOST_PID
                threads_seen.setdefault(tid, e["thread"])
            body.append({"name": e["name"], "ph": "X", "pid": pid,
                         "tid": tid, "ts": ts_us,
                         "dur": e.get("dur", 0.0) * scale, "args": args})
        else:
            tid = e["tid"]
            threads_seen.setdefault(tid, e["thread"])
            body.append({"name": e["name"], "ph": "i", "pid": _HOST_PID,
                         "tid": tid, "ts": ts_us, "s": "t", "args": args})
    out.append({"name": "process_name", "ph": "M", "pid": _HOST_PID,
                "args": {"name": "host threads"}})
    out.append({"name": "process_name", "ph": "M", "pid": _DEVICE_PID,
                "args": {"name": "device virtual time"}})
    for tid, tname in threads_seen.items():
        out.append({"name": "thread_name", "ph": "M", "pid": _HOST_PID,
                    "tid": tid, "args": {"name": tname}})
    for track, tid in tracks.items():
        out.append({"name": "thread_name", "ph": "M", "pid": _DEVICE_PID,
                    "tid": tid, "args": {"name": track}})
    out.extend(body)
    return out


def export_chrome(path: str, events: Optional[list[dict]] = None,
                  base_ns: Optional[int] = None) -> int:
    """Write ``{"traceEvents": [...]}`` JSON loadable in Perfetto /
    chrome://tracing (``base_ns`` as for :func:`to_chrome_events`). Returns
    the number of trace events written."""
    evs = to_chrome_events(events, base_ns)
    with open(path, "w") as f:
        json.dump({"traceEvents": evs,
                   "displayTimeUnit": "ms",
                   "otherData": {"dropped_events": dropped()}}, f)
    return len(evs)
