"""The end-to-end arithmetic: raw latencies to percentiles, bytes to a rate.

A command is one offload, from the client's call to its returned result.
Percentiles are taken from the raw latencies of the commands completed in
the window (linear between ranks), never from histogram buckets. A failed
command counts with an infinite latency, so it is over any limit; where a
percentile lands on one it reads as the window's length. ``zone_GBps`` is
the bytes read (each command's ``nbytes``) by the commands completed in the
window over the window's length, so a stall anywhere in the window lowers
it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional


@dataclass
class Record:
    """One command as the client saw it (``perf_counter`` seconds): numbers
    alone, so the window's records weigh little on the collector. The
    commands themselves come again from the seed after the window."""

    nbytes: int
    t0: float
    t1: float
    value: Optional[int] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile (0-100), linear between closest ranks, as
    numpy's default; ``inf`` where it touches an infinite value."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[lo]) or math.isinf(xs[hi]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_metrics(records: list[Record], t_start: float, seconds: float) -> dict:
    """``cmd_p50_ms``, ``cmd_p95_ms``, ``zone_GBps`` and ``completed`` over
    the commands that completed inside ``[t_start, t_start + seconds]``."""
    t_end = t_start + seconds
    done = [r for r in records if r.t0 >= t_start and r.t1 <= t_end]
    if not done:
        raise ValueError("no command completed in the window")
    lat = [(r.t1 - r.t0) * 1e3 if r.ok else math.inf for r in done]
    cap = seconds * 1e3

    def pct(q):
        v = percentile(lat, q)
        return cap if math.isinf(v) else v
    return {"cmd_p50_ms": pct(50), "cmd_p95_ms": pct(95),
            "zone_GBps": sum(r.nbytes for r in done if r.ok) / seconds / 1e9,
            "completed": len(done)}

