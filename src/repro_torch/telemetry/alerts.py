"""Alert rule engine over metric snapshots and event patterns.

The last consumer layer: :mod:`.health` says how each member *is*,
:mod:`.events` says what *happened* — this module decides when something
needs a reaction. An :class:`AlertEngine` holds a set of :class:`AlertRule`
objects and evaluates them on demand (:meth:`AlertEngine.evaluate`, the
deterministic path benchmarks and tests drive) or on a background sampling
interval (:meth:`AlertEngine.start`). Each evaluation builds one
:class:`AlertContext` — global-registry snapshot + previous snapshot, the
events published since the last evaluation, and the elapsed window — and
hands it to every rule.

Rules are **edge-triggered with incident tracking**: a rule reports the set
of currently-firing *incidents* (keyed strings, e.g. one per tenant or per
member); the engine fires an alert only when an incident key appears that
was not active on the previous evaluation, and publishes an
``alert.resolved`` event when it clears. A condition that stays true does
not re-fire every interval — the pager does not ring twice for one outage.

Firing alerts ARE events (``alert.<rule-name>`` in the shared event log,
severity from the rule) and additionally invoke callbacks registered with
:meth:`AlertEngine.on_alert` — the hook the ROADMAP's spare-promotion loop
will attach to; for now bench_health attaches one to prove the pipeline
fires end to end.

Shipped rules (the three the ISSUE names):

  * :class:`TenantLatencySLORule` — per-tenant p99 latency SLO breach, read
    from ``tenant.<t>.<series>.p99`` keys in the registry snapshot;
  * :class:`ErrorRateRule` — any matching error counter increasing faster
    than a threshold rate over the evaluation window;
  * :class:`HealthPromotionRule` — an array member promoted past SUSPECT
    into DEGRADED/OFFLINE (drives the health monitors' ``sample()``);

plus :class:`EventPatternRule` for thresholding on event bursts (e.g. "3+
``sq.stall`` events in one window").
"""
from __future__ import annotations

import fnmatch
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from .events import Event, EventLog, Severity, event_log
from .health import ArrayHealthMonitor, DeviceHealthMonitor, HealthStatus
from .metrics import MetricsRegistry, registry as global_registry

__all__ = [
    "Alert",
    "AlertContext",
    "AlertRule",
    "TenantLatencySLORule",
    "ErrorRateRule",
    "retry_storm_rule",
    "HealthPromotionRule",
    "EventPatternRule",
    "AlertEngine",
]


@dataclass(frozen=True)
class Alert:
    """One fired alert: which rule, which incident, and why."""

    rule: str
    key: str
    severity: Severity
    message: str
    t_wall: float
    tags: dict = field(default_factory=dict)


@dataclass
class AlertContext:
    """Everything a rule may look at for one evaluation."""

    snapshot: dict
    prev_snapshot: dict
    new_events: list[Event]
    dt: float                       # seconds since the previous evaluation

    def delta(self, key: str, default: float = 0.0) -> float:
        return self.snapshot.get(key, default) - \
            self.prev_snapshot.get(key, default)


class AlertRule:
    """Base rule: subclasses return ``{incident_key: (message, tags)}`` for
    every condition currently true. The engine handles edge-triggering."""

    def __init__(self, name: str, severity: Severity = Severity.ERROR):
        self.name = name
        self.severity = Severity(severity)

    def check(self, ctx: AlertContext) -> dict[str, tuple[str, dict]]:
        raise NotImplementedError


class TenantLatencySLORule(AlertRule):
    """Fires per tenant whose ``tenant.<t>.<series>.p99`` exceeds the SLO.

    ``series`` defaults to the scheduler's per-tenant end-to-end offload
    latency histogram; pass ``sq_admission_wait_seconds`` etc. to put an SLO
    on a different stage. Histograms with no samples publish no quantile
    keys, so idle tenants never page.
    """

    def __init__(self, slo_p99_seconds: float, *,
                 series: str = "offload_latency_seconds",
                 name: str = "tenant_p99_slo",
                 severity: Severity = Severity.ERROR):
        super().__init__(name, severity)
        self.slo_p99_seconds = float(slo_p99_seconds)
        self.series = series
        self._suffix = f".{series}.p99"

    def check(self, ctx: AlertContext) -> dict[str, tuple[str, dict]]:
        out: dict[str, tuple[str, dict]] = {}
        for key, val in ctx.snapshot.items():
            if not key.startswith("tenant.") or not key.endswith(self._suffix):
                continue
            tenant = key[len("tenant."):-len(self._suffix)]
            if val > self.slo_p99_seconds:
                out[tenant] = (
                    f"tenant {tenant!r} p99 {val * 1e3:.2f}ms breaches "
                    f"{self.slo_p99_seconds * 1e3:.2f}ms SLO ({self.series})",
                    {"tenant": tenant, "p99_s": val,
                     "slo_s": self.slo_p99_seconds})
        return out


class ErrorRateRule(AlertRule):
    """Fires per counter matching ``pattern`` (fnmatch glob) whose rate of
    increase over the window exceeds ``max_per_second``. With the default
    ``max_per_second=0.0`` any error growth at all fires — the right posture
    for an emulator where errors are injected, not ambient."""

    def __init__(self, *, pattern: str = "*_errors",
                 max_per_second: float = 0.0,
                 name: str = "error_rate",
                 severity: Severity = Severity.ERROR):
        super().__init__(name, severity)
        self.pattern = pattern
        self.max_per_second = float(max_per_second)

    def check(self, ctx: AlertContext) -> dict[str, tuple[str, dict]]:
        out: dict[str, tuple[str, dict]] = {}
        dt = max(ctx.dt, 1e-9)
        for key in ctx.snapshot:
            if not fnmatch.fnmatch(key, self.pattern):
                continue
            d = ctx.delta(key)
            if d > 0 and d / dt > self.max_per_second:
                out[key] = (
                    f"{key} grew by {d:g} in {ctx.dt:.3f}s "
                    f"({d / dt:.1f}/s > {self.max_per_second:g}/s)",
                    {"counter": key, "delta": d, "rate_per_s": d / dt})
        return out


def retry_storm_rule(*, max_per_second: float = 0.0,
                     name: str = "retry_storm",
                     severity: Severity = Severity.WARNING) -> ErrorRateRule:
    """The default retry-storm pager: fires per member whose absorbed-retry
    counter (``health.<member>.retries``, surfaced by
    ``DeviceHealthMonitor.register_on``) grows faster than
    ``max_per_second`` over the engine window. Retries are the SOFT fault
    signal — the datapath rode through them — so this pages an operator
    about a sick-but-serving member BEFORE exhausted budgets land in
    ``read_errors`` and the member is declared dead."""
    return ErrorRateRule(pattern="health.*.retries",
                         max_per_second=max_per_second,
                         name=name, severity=severity)


class HealthPromotionRule(AlertRule):
    """Fires when an array member's health status reaches ``at_least``
    (default DEGRADED) — the SUSPECT→DEGRADED promotion the spare-promotion
    loop keys off. Drives ``monitor.sample()`` on every evaluation so the
    engine's interval doubles as the SMART polling interval."""

    def __init__(self, monitor, *, at_least: HealthStatus = HealthStatus.DEGRADED,
                 sample: bool = True, name: str = "member_degraded",
                 severity: Severity = Severity.CRITICAL):
        super().__init__(name, severity)
        if not isinstance(monitor, (ArrayHealthMonitor, DeviceHealthMonitor)):
            raise TypeError("monitor must be an Array/DeviceHealthMonitor")
        self.monitor = monitor
        self.at_least = HealthStatus(at_least)
        self.sample = sample

    def _monitors(self) -> list[DeviceHealthMonitor]:
        if isinstance(self.monitor, ArrayHealthMonitor):
            return self.monitor.members
        return [self.monitor]

    def check(self, ctx: AlertContext) -> dict[str, tuple[str, dict]]:
        out: dict[str, tuple[str, dict]] = {}
        for m in self._monitors():
            status = m.sample() if self.sample else m.status
            if status >= self.at_least:
                out[m.name] = (
                    f"member {m.name} is {status.name} "
                    f"(threshold {self.at_least.name})",
                    {"device": m.name, "status": status.name})
        return out


class EventPatternRule(AlertRule):
    """Fires when ``min_count``+ events matching ``event_name`` (exact or
    dotted prefix) at ``min_severity``+ arrive within one evaluation
    window — burst detection over the event stream."""

    def __init__(self, event_name: str, *, min_count: int = 1,
                 min_severity: Severity = Severity.DEBUG,
                 name: Optional[str] = None,
                 severity: Severity = Severity.WARNING):
        super().__init__(name or f"burst_{event_name.replace('.', '_')}",
                         severity)
        self.event_name = event_name
        self.min_count = int(min_count)
        self.min_severity = Severity(min_severity)

    def check(self, ctx: AlertContext) -> dict[str, tuple[str, dict]]:
        hits = [e for e in ctx.new_events
                if e.severity >= self.min_severity and
                (e.name == self.event_name or
                 e.name.startswith(self.event_name + "."))]
        if len(hits) < self.min_count:
            return {}
        return {self.event_name: (
            f"{len(hits)} {self.event_name!r} events in {ctx.dt:.3f}s "
            f"(threshold {self.min_count})",
            {"event": self.event_name, "count": len(hits)})}


class AlertEngine:
    """Evaluates rules against the registry + event log; fires alerts as
    events and callbacks.

    Deterministic use (tests, benchmarks)::

        engine = AlertEngine(rules=[...])
        engine.on_alert(lambda a: reactions.append(a))
        fired = engine.evaluate()        # list[Alert] newly fired this pass

    Background use: ``engine.start(interval=0.5)`` runs ``evaluate`` on a
    daemon thread until ``stop()``.
    """

    def __init__(self, rules: Optional[list[AlertRule]] = None, *,
                 metrics: Optional[MetricsRegistry] = None,
                 events: Optional[EventLog] = None,
                 history: int = 256):
        self.rules: list[AlertRule] = list(rules or [])
        self.metrics = metrics if metrics is not None else global_registry()
        self.events = events if events is not None else event_log()
        self.fired: deque[Alert] = deque(maxlen=history)
        self._callbacks: list[Callable[[Alert], None]] = []
        self._active: dict[str, set[str]] = {}
        self._prev_snapshot: dict = {}
        self._last_eval = time.monotonic()
        self._last_seq = self.events.last_seq()
        self._lock = threading.Lock()
        # serializes whole evaluations: _active (incident edge state) is
        # read-modify-written across the rule loop, so two overlapping
        # evaluate() calls (background sampler + an explicit call, or a
        # callback that re-enters) could otherwise interleave and lose a
        # clear — suppressing the incident's alert.resolved
        self._eval_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def add_rule(self, rule: AlertRule) -> AlertRule:
        with self._lock:
            self.rules.append(rule)
        return rule

    def on_alert(self, fn: Callable[[Alert], None]) -> Callable[[], None]:
        """Register ``fn(alert)`` for every newly-fired alert; returns an
        unsubscribe callable."""
        with self._lock:
            self._callbacks.append(fn)

        def unsubscribe() -> None:
            with self._lock:
                if fn in self._callbacks:
                    self._callbacks.remove(fn)

        return unsubscribe

    # ----------------------------------------------------------- evaluation
    def evaluate(self) -> list[Alert]:
        """Run every rule once; returns the alerts that fired *this* pass
        (incidents newly active since the previous pass). Evaluations are
        serialized; callback exceptions are isolated exactly like rule
        exceptions (published as ``alert.callback_error`` events), so a
        broken consumer can neither wedge rule evaluation nor suppress a
        later ``alert.resolved``."""
        with self._eval_lock:
            return self._evaluate_locked()

    def _evaluate_locked(self) -> list[Alert]:
        with self._lock:
            now = time.monotonic()
            snap = self.metrics.snapshot()
            ctx = AlertContext(
                snapshot=snap,
                prev_snapshot=self._prev_snapshot,
                new_events=self.events.snapshot(since_seq=self._last_seq),
                dt=max(now - self._last_eval, 1e-9),
            )
            self._prev_snapshot = snap
            self._last_eval = now
            if ctx.new_events:
                self._last_seq = ctx.new_events[-1].seq
            rules = list(self.rules)
            callbacks = list(self._callbacks)

        new_alerts: list[Alert] = []
        for rule in rules:
            try:
                incidents = rule.check(ctx)
            except Exception:
                continue            # a broken rule must not stop the sweep
            prev_active = self._active.get(rule.name, set())
            for key, (message, tags) in incidents.items():
                if key in prev_active:
                    continue        # still firing, already alerted
                alert = Alert(rule=rule.name, key=key,
                              severity=rule.severity, message=message,
                              t_wall=time.time(), tags=dict(tags))
                new_alerts.append(alert)
                self.events.publish(
                    f"alert.{rule.name}", severity=rule.severity,
                    message=message, incident=key, **tags)
            for key in prev_active - set(incidents):
                self.events.publish(
                    "alert.resolved", severity=Severity.INFO,
                    message=f"{rule.name}/{key} cleared",
                    rule=rule.name, incident=key)
            self._active[rule.name] = set(incidents)

        for alert in new_alerts:
            self.fired.append(alert)
            for fn in callbacks:
                try:
                    fn(alert)
                except Exception as e:
                    # consumer bugs stay the consumer's — but not silently:
                    # a dead promotion hook is itself an operator incident
                    self.events.publish(
                        "alert.callback_error", severity=Severity.ERROR,
                        message=f"on_alert callback "
                                f"{getattr(fn, '__name__', repr(fn))} raised "
                                f"{type(e).__name__} for {alert.rule}/"
                                f"{alert.key}: {e}",
                        rule=alert.rule, incident=alert.key,
                        error=type(e).__name__)
        return new_alerts

    def active(self, rule: Optional[str] = None) -> dict[str, set[str]]:
        """Currently-firing incident keys per rule (as of the last
        evaluation)."""
        if rule is not None:
            return {rule: set(self._active.get(rule, set()))}
        return {r: set(keys) for r, keys in self._active.items()}

    # ------------------------------------------------------------ sampling
    def start(self, interval: float = 1.0) -> None:
        """Evaluate every ``interval`` seconds on a daemon thread."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval):
                self.evaluate()

        self._thread = threading.Thread(
            target=loop, name="alert-engine", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
