"""Observability for the emulator: tracing, metrics and the event log.

  * :mod:`repro_torch.telemetry.trace` — span recorder on wall and reactor
    virtual time, exportable as Chrome ``trace_event`` JSON.
  * :mod:`repro_torch.telemetry.metrics` — counters/gauges/histograms with
    snapshot/delta semantics and the global :func:`metrics.registry`.
  * :mod:`repro_torch.telemetry.events` — bounded structured event log.

Health monitors and alert rules come with the array slice of the port.
"""
from . import events, metrics, trace
from .events import Event, EventLog, Severity, event_log, publish
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, StatsView,
                      registry)
from .trace import span, instant, event_complete, tracing, set_enabled

__all__ = [
    "metrics", "trace", "events",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView",
    "registry",
    "span", "instant", "event_complete", "tracing", "set_enabled",
    "Event", "EventLog", "Severity", "event_log", "publish",
]
