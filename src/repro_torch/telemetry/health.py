"""SMART-style health monitoring per array member.

An NVMe device exposes a SMART / Health Information log page (error counts,
media wear, composite temperature) that fleet tooling polls to decide when a
drive is *about* to fail; a ZFS-style array manager layers pool health on
top (ONLINE / DEGRADED / FAULTED per vdev). This module is that consumer
side for the emulated ZNS fleet — PR 6 built the telemetry *producers*
(per-device counters and latency histograms); a :class:`DeviceHealthMonitor`
turns them into an operator verdict:

  * **error counters** — read/append protocol+media errors and zone
    READ_ONLY / OFFLINE transition counts, read straight off the device's
    private :class:`~repro_torch.telemetry.metrics.MetricsRegistry`;
  * **latency outlier detection** — an EWMA baseline of the mean emulated
    read/append latency per sampling window, with a deviation threshold
    (``outlier_factor``): a window whose mean exceeds ``factor x baseline``
    increments ``latency_outliers`` and publishes a ``health.latency_outlier``
    event (the drive-is-slowing signal SMART vendors encode as attribute
    thresholds);
  * **composite status** — HEALTHY / SUSPECT / DEGRADED / OFFLINE per
    device, recomputed each :meth:`sample`; every transition publishes a
    ``health.status`` event carrying the from/to pair, so the event log
    shows the escalation path a human would have watched.

Status semantics (deterministic, threshold-documented):

  * ``OFFLINE``  — every zone of the member is OFFLINE (the device is gone);
  * ``DEGRADED`` — the OFFLINE-zone fraction reached
    ``degraded_zone_fraction`` (default 0.5), or the window error rate
    (errors / I/O ops) reached ``error_rate_threshold``;
  * ``SUSPECT``  — anything visibly wrong short of that: any OFFLINE or
    READ_ONLY zone, any window errors, or a latency outlier within the last
    ``suspect_memory_windows`` samples;
  * ``HEALTHY``  — none of the above.

:meth:`smart_log` returns the whole picture as one dict (the log-page
analogue); :meth:`register_on` folds the numeric subset into a registry
snapshot as a collector. :class:`ArrayHealthMonitor` runs one monitor per
array member — the input the alert engine's SUSPECT→DEGRADED promotion rule
(and the ROADMAP's future spare-promotion loop) consumes.

The module deliberately duck-types the device (``.metrics``,
``.report_zones()``, ``.dev_ordinal``) instead of importing
:mod:`repro_torch.zns.device` — the device imports the telemetry package, so a
typed import here would be circular. Zone states compare by their ``.value``
strings for the same reason.
"""
from __future__ import annotations

import enum
import threading
import time
from typing import Optional

from .events import EventLog, Severity, event_log
from .metrics import MetricsRegistry

__all__ = ["HealthStatus", "DeviceHealthMonitor", "ArrayHealthMonitor"]


class HealthStatus(enum.IntEnum):
    """Composite member verdict; ordered so ``>=`` severity tests work."""

    HEALTHY = 0
    SUSPECT = 1
    DEGRADED = 2
    OFFLINE = 3


# scrub_mismatches: parity/mirror inconsistencies the background scrub
# (repro_torch.array.rebuild) charged to this device — silent corruption counts
# as a media error for classification, same as an explicit read error
_ERROR_KEYS = ("read_errors", "append_errors", "scrub_mismatches")
_OPS_KEYS = ("blocks_read", "blocks_appended")
# Soft fault signals: retries the datapath ABSORBED and per-op timeouts.
# They classify a member SUSPECT (a retry storm pages before a hard
# failure does) but never DEGRADED — only exhausted retry budgets land in
# read_errors/append_errors and trigger ejection/rebuild.
_SOFT_KEYS = ("retries", "io_timeouts")


class DeviceHealthMonitor:
    """SMART-log consumer for one emulated ZNS device.

    Call :meth:`sample` periodically (the alert engine's interval, a
    dashboard refresh, or explicitly in tests/benchmarks); each call reads
    the device's metrics registry and zone report, updates the EWMA latency
    baselines, and recomputes the composite status. All state transitions
    publish into ``events`` (the global log by default).
    """

    def __init__(
        self,
        device,
        *,
        ewma_alpha: float = 0.3,
        outlier_factor: float = 4.0,
        min_baseline_windows: int = 3,
        suspect_memory_windows: int = 3,
        degraded_zone_fraction: float = 0.5,
        error_rate_threshold: float = 0.01,
        events: Optional[EventLog] = None,
        name: Optional[str] = None,
    ):
        self.device = device
        self.ewma_alpha = float(ewma_alpha)
        self.outlier_factor = float(outlier_factor)
        self.min_baseline_windows = int(min_baseline_windows)
        self.suspect_memory_windows = int(suspect_memory_windows)
        self.degraded_zone_fraction = float(degraded_zone_fraction)
        self.error_rate_threshold = float(error_rate_threshold)
        self.events = events if events is not None else event_log()
        self.name = name or f"dev{getattr(device, 'dev_ordinal', '?')}"
        self._lock = threading.Lock()
        self._t_created = time.monotonic()
        self._prev_snap: dict = {}
        # per-op EWMA state: baseline mean seconds + windows folded in
        self._ewma = {"read": 0.0, "append": 0.0}
        self._ewma_n = {"read": 0, "append": 0}
        self._windows = 0
        self._last_outlier_window = -10**9
        self.latency_outliers = 0
        self._status = HealthStatus.HEALTHY
        # last-window deltas, kept for smart_log / debugging
        self._win_errors = 0
        self._win_ops = 0
        self._win_soft = 0

    # ------------------------------------------------------------ sampling
    def _zone_counts(self) -> tuple[int, int, int]:
        zones = self.device.report_zones()
        off = sum(1 for z in zones if z.state.value == "offline")
        ro = sum(1 for z in zones if z.state.value == "read_only")
        return len(zones), off, ro

    def _update_ewma(self, op: str, snap: dict, prev: dict) -> bool:
        """Fold one window of ``<op>.service_seconds`` into the EWMA
        baseline; True when the window is an outlier against a warm
        baseline."""
        count = snap.get(f"{op}.service_seconds.count", 0) - \
            prev.get(f"{op}.service_seconds.count", 0)
        total = snap.get(f"{op}.service_seconds.sum", 0.0) - \
            prev.get(f"{op}.service_seconds.sum", 0.0)
        if count <= 0:
            return False            # idle window: baseline unchanged
        mean = total / count
        base = self._ewma[op]
        warm = self._ewma_n[op] >= self.min_baseline_windows
        outlier = warm and base > 0 and mean > self.outlier_factor * base
        if not outlier:
            # outlier windows are excluded from the baseline — a sick device
            # must not teach the monitor that sick is normal
            self._ewma[op] = mean if self._ewma_n[op] == 0 else \
                (1 - self.ewma_alpha) * base + self.ewma_alpha * mean
            self._ewma_n[op] += 1
        return outlier

    def sample(self) -> HealthStatus:
        """Read the device, update baselines, recompute + publish status."""
        with self._lock:
            snap = self.device.metrics.snapshot()
            prev, self._prev_snap = self._prev_snap, snap
            self._windows += 1
            outlier = False
            for op in ("read", "append"):
                if self._update_ewma(op, snap, prev):
                    outlier = True
            if outlier:
                self.latency_outliers += 1
                self._last_outlier_window = self._windows
            self._win_errors = sum(
                snap.get(k, 0) - prev.get(k, 0) for k in _ERROR_KEYS)
            self._win_ops = sum(
                snap.get(k, 0) - prev.get(k, 0) for k in _OPS_KEYS)
            self._win_soft = sum(
                snap.get(k, 0) - prev.get(k, 0) for k in _SOFT_KEYS)
            n_zones, off, ro = self._zone_counts()
            status = self._classify(n_zones, off, ro, outlier)
            prev_status, self._status = self._status, status
        if outlier:
            self.events.publish(
                "health.latency_outlier", severity=Severity.WARNING,
                message=f"{self.name}: window latency exceeded "
                        f"{self.outlier_factor:g}x EWMA baseline",
                device=self.name)
        if status is not prev_status:
            sev = Severity.INFO if status is HealthStatus.HEALTHY else (
                Severity.WARNING if status is HealthStatus.SUSPECT
                else Severity.ERROR)
            self.events.publish(
                "health.status", severity=sev,
                message=f"{self.name}: {prev_status.name} -> {status.name}",
                device=self.name, from_status=prev_status.name,
                to_status=status.name)
        return status

    def _classify(self, n_zones: int, off: int, ro: int,
                  outlier: bool) -> HealthStatus:
        if n_zones and off == n_zones:
            return HealthStatus.OFFLINE
        error_rate = self._win_errors / self._win_ops \
            if self._win_ops > 0 else (1.0 if self._win_errors else 0.0)
        if (n_zones and off / n_zones >= self.degraded_zone_fraction) or \
                (self._win_errors and
                 error_rate >= self.error_rate_threshold):
            return HealthStatus.DEGRADED
        recent_outlier = outlier or (
            self._windows - self._last_outlier_window
            < self.suspect_memory_windows)
        if off or ro or self._win_errors or self._win_soft or recent_outlier:
            return HealthStatus.SUSPECT
        return HealthStatus.HEALTHY

    # ------------------------------------------------------------- reports
    @property
    def status(self) -> HealthStatus:
        """Last sampled status (HEALTHY before the first :meth:`sample`)."""
        return self._status

    def smart_log(self) -> dict:
        """The NVMe SMART / Health Information log-page analogue: one dict
        with the composite status, raw counters, zone-state census, latency
        baselines and outlier counts."""
        with self._lock:
            snap = self.device.metrics.snapshot()
            n_zones, off, ro = self._zone_counts()
            return {
                "device": self.name,
                "status": self._status.name,
                "status_code": int(self._status),
                "power_on_seconds": time.monotonic() - self._t_created,
                "blocks_read": snap.get("blocks_read", 0),
                "blocks_appended": snap.get("blocks_appended", 0),
                "read_errors": snap.get("read_errors", 0),
                "append_errors": snap.get("append_errors", 0),
                "scrub_mismatches": snap.get("scrub_mismatches", 0),
                "media_errors": sum(snap.get(k, 0) for k in _ERROR_KEYS),
                "retries": snap.get("retries", 0),
                "io_timeouts": snap.get("io_timeouts", 0),
                "faults_injected": snap.get("faults_injected", 0),
                "zone_resets": snap.get("zone_resets", 0),
                "zone_readonly_transitions":
                    snap.get("zone_readonly_transitions", 0),
                "zone_offline_transitions":
                    snap.get("zone_offline_transitions", 0),
                "zones": n_zones,
                "zones_offline": off,
                "zones_read_only": ro,
                "latency_outliers": self.latency_outliers,
                "read_latency_baseline_s": self._ewma["read"],
                "append_latency_baseline_s": self._ewma["append"],
                "read_p99_s": snap.get("read.service_seconds.p99", 0.0),
                "append_p99_s": snap.get("append.service_seconds.p99", 0.0),
                "sample_windows": self._windows,
            }

    def register_on(self, registry: MetricsRegistry) -> None:
        """Fold the numeric SMART attributes into ``registry`` snapshots as
        a ``health.<name>`` collector (idempotent re-registration)."""
        def collect() -> dict:
            log = self.smart_log()
            return {k: v for k, v in log.items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)}
        registry.register_collector(f"health.{self.name}", collect)


class ArrayHealthMonitor:
    """One :class:`DeviceHealthMonitor` per member of a striped array —
    the pool-health view an array manager polls.

    ``sample()`` samples every member and returns ``{member_index: status}``;
    ``worst()`` is the pool verdict. The monitors publish their own
    transition events; the alert engine's promotion rule watches
    :meth:`statuses` for members crossing into DEGRADED.
    """

    def __init__(self, array, *, events: Optional[EventLog] = None, **kw):
        self.array = array
        self.events = events if events is not None else event_log()
        self.members = [
            DeviceHealthMonitor(
                d, events=self.events,
                name=f"member{i}/dev{getattr(d, 'dev_ordinal', i)}", **kw)
            for i, d in enumerate(array.devices)
        ]

    def sample(self) -> dict[int, HealthStatus]:
        return {i: m.sample() for i, m in enumerate(self.members)}

    def statuses(self) -> dict[int, HealthStatus]:
        return {i: m.status for i, m in enumerate(self.members)}

    def worst(self) -> HealthStatus:
        return max((m.status for m in self.members),
                   default=HealthStatus.HEALTHY)

    def smart_logs(self) -> list[dict]:
        return [m.smart_log() for m in self.members]

    def register_on(self, registry: MetricsRegistry) -> None:
        for m in self.members:
            m.register_on(registry)
