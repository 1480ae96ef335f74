"""The traced run: a short steady slice of the window under the port's span
tracer and ``torch.profiler``, and what the per-layer readers get from it.

The slice starts a third into the window. It ends once it has lasted
``SLICE_S`` (or a third of a shorter window) and holds at least
``SLICE_MIN_COMMANDS`` commands, at ``SLICE_MAX_COMMANDS`` commands, or at
the window's close, whichever comes first. Each command in it runs inside a ``record_function`` marker, so the
profiler's device operations are given to the command whose marker holds
them (a command returns only once its result is on the host, so its device
work lies inside its marker). The port's spans are on ``time.monotonic``;
the markers fix the offset between that clock and the profiler's.

The Chrome trace goes to ``build/zcsd_bench/<cell>.trace.json`` in the
checkout, overwritten by the cell's next traced run.
"""
from __future__ import annotations

import bisect
import json
import statistics
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from zcsd_bench import bound

SLICE_S = 3.0
SLICE_MIN_COMMANDS = 50
SLICE_MAX_COMMANDS = 2000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclass
class SliceCommand:
    """A command of the slice: its record, the command, the port's stats,
    the port's launch count for it, its span-clock interval and its
    marker's index."""

    rec: object
    command: object
    stats: object
    launches: int
    mono0: float
    mono1: float
    index: int


@dataclass
class DeviceTrace:
    """The profiler's view of the slice, in seconds on its clock."""

    window: tuple[float, float]
    ops: list                       # (name, cat, t0, t1) of device operations
    markers: dict                   # command index -> (t0, t1)

    def __post_init__(self):
        self.ops.sort(key=lambda o: o[2])
        self._kernels = [o for o in self.ops if o[1] == "kernel"]
        self._starts = [o[2] for o in self._kernels]

    def kernels_between(self, t0: float, t1: float) -> list:
        """The kernels that start inside ``[t0, t1]``."""
        return self._kernels[bisect.bisect_left(self._starts, t0):
                             bisect.bisect_right(self._starts, t1)]


def parse_chrome(events: list[dict]) -> Optional[DeviceTrace]:
    """Device operations, the slice marker and the command markers of a
    Kineto Chrome trace; ``None`` without a slice marker."""
    ops, markers, window = [], {}, None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        t0 = float(e["ts"]) * 1e-6
        t1 = t0 + float(e.get("dur", 0.0)) * 1e-6
        name = str(e.get("name", ""))
        if cat in DEVICE_CATS:
            ops.append((name, cat, t0, t1))
        elif cat == "user_annotation":
            if name == "zb.slice":
                window = (t0, t1)
            elif name.startswith("zb.cmd."):
                markers[int(name[len("zb.cmd."):])] = (t0, t1)
    if window is None:
        return None
    return DeviceTrace(window, ops, markers)


def merge(intervals: list[tuple[float, float]], lo: float,
          hi: float) -> list[tuple[float, float]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, as sorted
    disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: list[tuple[float, float]], lo: float,
         hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that ``busy`` (merged) leaves free."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


@dataclass
class TraceData:
    """What a per-layer reader gets: ``read(trace) -> float | None``."""

    config: dict
    reference: object               # the configuration's reference module
    root: str                       # the kind's span around one command
    commands: list                  # SliceCommand, in order
    spans: list                     # the port's spans (monotonic seconds)
    device: Optional[DeviceTrace]
    offset: Optional[float] = None  # profiler clock minus span clock

    def __post_init__(self):
        self._starts = [c.mono0 for c in self.commands]
        self._spans_of: dict[int, list] = {}
        for s in self.spans:
            i = self._command_at(s["ts"])
            if i is not None:
                self._spans_of.setdefault(i, []).append(s)

    def _command_at(self, t: float) -> Optional[int]:
        """The position of the command whose span-clock interval holds ``t``."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t <= self.commands[i].mono1:
            return i
        return None

    def spans_of(self, pos: int) -> list:
        return self._spans_of.get(pos, [])

    def bound_seconds(self, cmd: SliceCommand) -> float:
        """The least time of the command's work, as the reference counts it."""
        return bound.least_seconds(*self.reference.work(self.config, cmd.command))

    def busy_intervals(self) -> list[tuple[float, float]]:
        lo, hi = self.device.window
        return merge([(o[2], o[3]) for o in self.device.ops], lo, hi)

    def seen_in_full(self) -> tuple[list, dict]:
        """The commands whose kernel launches the profiler saw in full, each
        with every kernel inside its marker, and the coverage counts. A
        command's launches are the port's launch counters' increase; a seen
        launch is a kernel whose name holds the configuration's
        ``kernel.name_contains``."""
        full, counted, seen_all = [], 0, 0
        if self.device is None:
            return full, {}
        name = self.config["kernel"]["name_contains"]
        for c in self.commands:
            m = self.device.markers.get(c.index)
            if m is None or not c.rec.ok:
                continue
            ks = self.device.kernels_between(*m)
            seen = sum(1 for k in ks if name in k[0])
            counted += c.launches
            seen_all += seen
            if c.launches > 0 and seen == c.launches:
                full.append((c, ks))
        return full, {"commands": len(self.commands), "seen_in_full": len(full),
                      "launches_counted": counted, "launches_seen": seen_all}


class SliceTracer:
    """Turns the port's span tracer and the profiler on for the slice.

    The profiler is made ready (its warm-up step, which loads and starts
    CUPTI, several seconds on the card's machine) in set-up by
    :meth:`prepare`; the slice records from its start to its end (see the
    module's docstring)."""

    def __init__(self, seconds: float, trace_mod, cuda: bool, path: Path):
        self.seconds = seconds
        self.length = min(SLICE_S, seconds / 3)
        self._trace = trace_mod
        self._cuda = cuda
        self.path = path
        self._prof = None
        self._slice = None
        self._done = False
        self.commands: list[SliceCommand] = []
        self.spans: list = []

    def prepare(self) -> None:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self._cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._prof = torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(str(self.path)))
        self._prof.__enter__()

    def begin(self, t_start: float) -> None:
        """The window opens at ``t_start``: the slice a third into it."""
        self.lo = t_start + self.seconds / 3

    def active(self, now: float) -> bool:
        """Start or stop the slice as ``now`` passes its ends."""
        if self._slice is None and not self._done and now >= self.lo:
            import torch
            self._trace.clear()
            self._trace.set_enabled(True)
            self._prof.step()                   # warm-up -> recording
            self._slice = torch.profiler.record_function("zb.slice")
            self._slice.__enter__()
            self.hi = time.perf_counter() + self.length
        elif self._slice is not None and (
                (now >= self.hi and len(self.commands) >= SLICE_MIN_COMMANDS)
                or len(self.commands) >= SLICE_MAX_COMMANDS):
            self.stop()
        return self._slice is not None

    def marker(self, index: int):
        import torch
        return torch.profiler.record_function(f"zb.cmd.{index}")

    def stop(self) -> None:
        """End the slice (the trace is written) and the profiler."""
        if self._slice is not None:
            self._slice.__exit__(None, None, None)
            self._slice = None
            self._done = True
            self._trace.set_enabled(False)
            self.spans = [s for s in self._trace.drain() if s["type"] == "span"]
            self._trace.clear()
            self._prof.step()                   # recording -> saved
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self._prof = None

    def data(self, config: dict, reference, root: str) -> TraceData:
        """What the readers get; no device trace without a card."""
        device = None
        if self._done and self._cuda:
            with open(self.path) as f:
                device = parse_chrome(json.load(f).get("traceEvents", []))
        offset = None
        if device is not None:
            diffs = [device.markers[c.index][0] - c.mono0
                     for c in self.commands if c.index in device.markers]
            offset = statistics.median(diffs) if diffs else None
        return TraceData(config, reference, root, self.commands, self.spans, device,
                         offset)


def breakdown(td: TraceData) -> Optional[dict]:
    """The slice's top device operations, and its idle time by the
    innermost port span open at each gap's midpoint (``client`` outside
    any command: the benchmark's own loop; ``command`` inside one where no
    span is open)."""
    if td.device is None or td.offset is None:
        return None
    lo, hi = td.device.window
    by_name: dict[str, float] = {}
    for name, _, a, b in td.device.ops:
        d = min(b, hi) - max(a, lo)
        if d > 0:
            by_name[name[:160]] = by_name.get(name[:160], 0.0) + d
    idle: dict[str, float] = {}
    for a, b in gaps(td.busy_intervals(), lo, hi):
        mid = (a + b) / 2 - td.offset          # on the span clock
        pos = td._command_at(mid)
        label = "client"
        if pos is not None:
            open_ = [s for s in td.spans_of(pos) if s["ts"] <= mid <= s["ts"] + s["dur"]]
            label = max(open_, key=lambda s: s["ts"])["name"] if open_ else "command"
        idle[label] = idle.get(label, 0.0) + (b - a)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(by_name), "idle_gaps": top(idle)}
