"""Metrics registry: counters, gauges, and fixed-bucket latency histograms.

The emulator's instrumentation grew as scattered ad-hoc ``stats`` dicts —
``ZonedDevice.stats``, ``ArrayOffloadStats``, checkpoint/pipeline counters —
each with its own shape and, worse, unlocked read-modify-write increments
racing under the reactor and gather threads. This module is the one
substrate they all migrate onto:

  * :class:`Counter` — monotonically increasing integer, atomic ``inc``
    (a private lock; Python's ``d[k] += n`` is NOT atomic across threads);
  * :class:`Gauge` — last-write-wins float (queue occupancy, ratios);
  * :class:`Histogram` — fixed log-spaced buckets with exact count/sum/
    min/max and interpolated p50/p95/p99 (the latency quantiles the
    multi-tenant QoS work reports per tenant);
  * :class:`MetricsRegistry` — a named namespace of the above with
    ``snapshot()`` / ``delta()`` semantics and a text ``dump()``. Collector
    callbacks fold externally-owned stats (compile cache, reactor) into the
    same snapshot so one call shows the whole offload picture.

Components that exist in unbounded numbers (devices, checkpoint stores) own
a PRIVATE registry (``obj.metrics``) and expose their legacy dict-shaped
``stats`` through :class:`StatsView` — the dict API stays source-compatible
while every increment becomes atomic. Process-wide singletons (the reactor,
the gather pool, the per-tenant queues, the shared compile cache) publish to
the global :func:`registry`.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Callable, Iterable, Iterator, MutableMapping, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "StatsView",
    "registry",
    "default_latency_buckets",
]


class Counter:
    """Monotonic integer counter with atomic increments.

    ``set`` exists only for the legacy dict API (tests zero device counters
    with ``dev.stats["blocks_read"] = 0``); new code should only ``inc``.
    """

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def set(self, value: int) -> None:
        with self._lock:
            self._value = int(value)

    @property
    def value(self) -> int:
        return self._value

    def __repr__(self) -> str:
        return f"Counter({self.name}={self._value})"


class Gauge:
    """Last-write-wins scalar (occupancy, depth, a ratio)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        self._value = float(value)

    def max(self, value: float) -> None:
        """Raise the gauge to ``value`` if it is higher (high-water marks)."""
        with self._lock:
            if value > self._value:
                self._value = float(value)

    @property
    def value(self) -> float:
        return self._value

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self._value})"


def default_latency_buckets() -> tuple[float, ...]:
    """Log-spaced seconds boundaries, 1 µs .. ~67 s at ratio 2 — one decade
    of relative error per bucket is plenty for p50/p95/p99 of emulated I/O."""
    return tuple(1e-6 * 2.0 ** i for i in range(27))


class Histogram:
    """Fixed-bucket histogram with interpolated quantiles.

    Buckets are upper-bound boundaries (values land in the first bucket whose
    bound is >= value; an overflow bucket catches the rest). Exact ``count``,
    ``sum``, ``min``, ``max`` are kept alongside, so means are exact and
    quantiles are only as coarse as the bucket geometry. ``observe`` takes
    one lock — cheap enough for the emulated-I/O hot path, and exact under
    the reactor/gather/dispatcher thread mix (asserted by the telemetry
    concurrency stress test).
    """

    __slots__ = ("name", "bounds", "_counts", "_overflow", "_count", "_sum",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, buckets: Optional[Iterable[float]] = None):
        self.name = name
        self.bounds = tuple(sorted(buckets)) if buckets is not None \
            else default_latency_buckets()
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * len(self.bounds)
        self._overflow = 0
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            if i < len(self.bounds):
                self._counts[i] += 1
            else:
                self._overflow += 1
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Linear-interpolated quantile estimate (``q`` in [0, 100]).

        Within the target bucket the mass is assumed uniform between the
        bucket's bounds (clamped to the observed min/max), so the error is
        bounded by the bucket width at that value.
        """
        with self._lock:
            count = self._count
            if count == 0:
                return 0.0
            rank = q / 100.0 * count
            seen = 0.0
            lo = max(self._min, 0.0) if self._min != math.inf else 0.0
            for bound, c in zip(self.bounds, self._counts):
                if c:
                    hi = min(bound, self._max)
                    blo = max(lo, self._min)
                    if seen + c >= rank:
                        frac = min(max((rank - seen) / c, 0.0), 1.0)
                        return blo + (hi - blo) * frac if hi > blo else hi
                    seen += c
                lo = bound
            # overflow bucket: interpolate toward the observed max
            c = self._overflow
            if c:
                blo = max(lo, self._min)
                hi = self._max
                frac = min(max((rank - seen) / c, 0.0), 1.0)
                return blo + (hi - blo) * frac if hi > blo else hi
            return self._max

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
            mn = self._min if self._count else 0.0
            mx = self._max if self._count else 0.0
        out = {
            "count": count,
            "sum": total,
            "mean": total / count if count else 0.0,
            "min": mn,
            "max": mx,
        }
        if count:
            # no quantile keys for an empty histogram: a fabricated p99 of
            # 0.0 reads as "perfect latency" to SLO rules and dashboards,
            # the opposite of "no data" — absent keys make idle series
            # unambiguous (and keep idle tenants from ever paging)
            out.update(p50=self.percentile(50), p95=self.percentile(95),
                       p99=self.percentile(99))
        return out

    def __repr__(self) -> str:
        return f"Histogram({self.name} n={self._count} mean={self.mean:.3g})"


class StatsView(MutableMapping):
    """Dict-shaped view over named :class:`Counter` objects.

    Source-compatible stand-in for the old ad-hoc ``stats`` dicts:
    ``stats["k"]`` reads the counter, ``stats["k"] = v`` resets it (a
    test-suite idiom), ``items()``/iteration/``len`` work, and extra
    key/value pairs (computed aggregates like the array's
    ``degraded_reads``) can be layered on. The OWNING component must
    increment through the counters (``c.inc(n)``), never through this view —
    that is what makes the increments atomic.
    """

    def __init__(self, counters: dict[str, Counter]):
        self._counters = dict(counters)

    def __getitem__(self, key: str) -> int:
        return self._counters[key].value

    def __setitem__(self, key: str, value: int) -> None:
        self._counters[key].set(value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("stats keys are fixed at construction")

    def __iter__(self) -> Iterator[str]:
        return iter(self._counters)

    def __len__(self) -> int:
        return len(self._counters)

    def __repr__(self) -> str:
        return repr(dict(self))


class MetricsRegistry:
    """A named namespace of metrics with snapshot/delta semantics.

    ``counter``/``gauge``/``histogram`` get-or-create by name (with a type
    check, so one name cannot be two kinds of metric). ``snapshot()``
    flattens everything into one ``{name: value}`` dict — histograms expand
    to ``name.count``/``.sum``/``.mean``/``.min``/``.max``/``.p50``/``.p95``/
    ``.p99`` — and folds in every registered collector. ``delta(old)``
    subtracts a previous snapshot's cumulative values (counters, histogram
    counts/sums) while keeping point-in-time values (gauges, quantiles)
    as-is, which is what benchmarks want for a measurement window.
    """

    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._collectors: dict[str, Callable[[], dict]] = {}

    # ------------------------------------------------------------- creation
    def _get_or_create(self, name: str, kind: type, factory: Callable):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str,
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._get_or_create(name, Histogram,
                                   lambda: Histogram(name, buckets))

    def register_collector(self, name: str, fn: Callable[[], dict]) -> None:
        """``fn()`` returns ``{suffix: number}`` folded into ``snapshot()``
        under ``name.suffix`` — for stats owned elsewhere (compile cache,
        reactor) that should appear in the same picture. Re-registering a
        name replaces the collector (idempotent wiring)."""
        with self._lock:
            self._collectors[name] = fn

    # ------------------------------------------------------------ snapshots
    def snapshot(self) -> dict:
        with self._lock:
            metrics = list(self._metrics.items())
            collectors = list(self._collectors.items())
        out: dict[str, float] = {}
        for name, m in metrics:
            if isinstance(m, Counter):
                out[name] = m.value
            elif isinstance(m, Gauge):
                out[name] = m.value
            else:
                for k, v in m.snapshot().items():
                    out[f"{name}.{k}"] = v
        for name, fn in collectors:
            try:
                for k, v in fn().items():
                    out[f"{name}.{k}"] = v
            except Exception:
                pass  # a dead collector must not poison the snapshot
        return out

    _CUMULATIVE_SUFFIXES = (".count", ".sum")

    def delta(self, old: dict, new: Optional[dict] = None) -> dict:
        """Subtract cumulative values in ``old`` from ``new`` (default: a
        fresh snapshot). Counters and histogram ``.count``/``.sum`` subtract;
        gauges/quantiles/min/max pass through as point-in-time values."""
        if new is None:
            new = self.snapshot()
        out = dict(new)
        for k, v in old.items():
            if k not in out or not isinstance(v, (int, float)):
                continue
            if isinstance(out[k], int) or k.endswith(self._CUMULATIVE_SUFFIXES):
                out[k] = out[k] - v
        return out

    def dump(self) -> str:
        """Human-readable metrics table, sorted by name."""
        snap = self.snapshot()
        width = max((len(k) for k in snap), default=0)
        lines = [f"# metrics{' ' + self.name if self.name else ''} "
                 f"({len(snap)} series)"]
        for k in sorted(snap):
            v = snap[k]
            sv = f"{v:d}" if isinstance(v, int) else f"{v:.6g}"
            lines.append(f"{k:<{width}}  {sv}")
        return "\n".join(lines)

    def reset(self) -> None:
        """Drop every metric and collector (tests / benchmark isolation on
        the global registry)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


_global = MetricsRegistry("global")


def registry() -> MetricsRegistry:
    """The process-wide registry: reactor, gather pool, per-tenant queues,
    scheduler phase timings, and the shared compile cache publish here, so
    one ``registry().snapshot()`` shows the whole offload picture."""
    return _global
