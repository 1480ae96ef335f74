"""Observability for the emulator: tracing, metrics, events, health, alerts.

  * :mod:`repro_torch.telemetry.trace` — span recorder on wall and reactor
    virtual time, exportable as Chrome ``trace_event`` JSON.
  * :mod:`repro_torch.telemetry.metrics` — counters/gauges/histograms with
    snapshot/delta semantics and the global :func:`metrics.registry`.
  * :mod:`repro_torch.telemetry.events` — bounded structured event log.
  * :mod:`repro_torch.telemetry.health` — SMART-style per-device health:
    error counters, EWMA latency-outlier detection, composite
    HEALTHY/SUSPECT/DEGRADED/OFFLINE status, ``smart_log()`` dicts.
  * :mod:`repro_torch.telemetry.alerts` — rule engine over metric snapshots
    and event patterns (per-tenant p99 SLO, error rates, health
    promotions); firing alerts are events and invoke registered callbacks.
"""
from . import alerts, events, health, metrics, trace
from .alerts import (Alert, AlertEngine, AlertRule, ErrorRateRule,
                     EventPatternRule, HealthPromotionRule,
                     TenantLatencySLORule, retry_storm_rule)
from .events import Event, EventLog, Severity, event_log, publish
from .health import ArrayHealthMonitor, DeviceHealthMonitor, HealthStatus
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, StatsView,
                      registry)
from .trace import span, instant, event_complete, tracing, set_enabled

__all__ = [
    "metrics", "trace", "events", "health", "alerts",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView",
    "registry",
    "span", "instant", "event_complete", "tracing", "set_enabled",
    "Event", "EventLog", "Severity", "event_log", "publish",
    "HealthStatus", "DeviceHealthMonitor", "ArrayHealthMonitor",
    "Alert", "AlertEngine", "AlertRule", "TenantLatencySLORule",
    "ErrorRateRule", "retry_storm_rule", "HealthPromotionRule",
    "EventPatternRule",
]
