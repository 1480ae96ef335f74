"""Emulated NVMe Zoned Namespace (ZNS) device.

Semantics mirror the NVMe ZNS command set the paper targets (TP 4053, ratified
June 2020):

  * the LBA space is divided into fixed-size zones;
  * writes within a zone are append-only at the zone's write pointer
    ("Zone Append" command);
  * no in-place updates -- rewriting requires a host-managed ``reset_zone``;
  * zones move through an explicit state machine
    EMPTY -> (IMPLICITLY) OPEN -> FULL, with FINISH and RESET transitions
    driven by the host;
  * reads are block (LBA) granular and bounds-checked against the write
    pointer.

The device is backed either by host memory (default; fast, used by tests and
the data/KV substrates) or by a memory-mapped file (persistence for the
checkpoint store). Emulation knobs (``read_us_per_block``/``append_us_per_block``)
let benchmarks model device bandwidth, as QEMU does for the paper; transfer
timing runs through per-zone virtual-time queues retired by a shared
:class:`~repro_torch.zns.ring.IoReactor`, so ``submit_read``/``submit_append`` keep
arbitrarily many transfers in flight without a thread per transfer (the
NVMe-style asynchronous interface the paper's device sits behind).
"""
from __future__ import annotations

import enum
import itertools
import threading
import time
import weakref
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.faults.errors import (IoTimeoutError, TornAppendError,
                                 TransientIOError)
from repro_torch.faults.injector import FaultDecision
from repro_torch.faults.retry import RetryPolicy, drive_retries
from repro_torch.telemetry import trace as _trace
from repro_torch.telemetry.events import Severity as _Sev, publish as _publish_event
from repro_torch.telemetry.metrics import MetricsRegistry, StatsView
from repro_torch.zns.ring import CompletionRing, IoFuture, IoReactor

# the "no injector attached" decision and the "no policy set" policy: a
# single attempt, no backoff, no timeout — byte-for-byte the legacy behavior
_NO_FAULT = FaultDecision()
_SINGLE_ATTEMPT = RetryPolicy(max_attempts=1, backoff_base_s=0.0,
                              timeout_s=None)

__all__ = [
    "ZoneState",
    "Zone",
    "ZonedDevice",
    "ZNSError",
    "ZoneFullError",
    "ZoneStateError",
    "OutOfBoundsError",
    "payload_as_uint8",
]


def payload_as_uint8(data: np.ndarray | bytes | bytearray) -> np.ndarray:
    """Coerce an append payload to a flat uint8 stream.

    The ONE coercion shared by :meth:`ZonedDevice.zone_append` and the striped
    array's logical append — a drift between the two would silently corrupt
    stripe interleaving, so it lives here once.
    """
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data).view(np.uint8).reshape(-1)


def block_aligned_dtype(block_bytes: int, dtype: np.dtype | str) -> np.dtype:
    """Validate that ``dtype`` elements tile a block exactly and return the
    normalized dtype — the ONE alignment rule behind every typed read
    (sync/async, device/array); a drift between those paths would silently
    retype extents differently."""
    dtype = np.dtype(dtype)
    if block_bytes % dtype.itemsize:
        raise ValueError(
            f"block size {block_bytes} not a multiple of "
            f"{dtype} itemsize {dtype.itemsize}")
    return dtype


class ZNSError(Exception):
    """Base error for ZNS protocol violations."""


class ZoneFullError(ZNSError):
    """Append past the end of a zone."""


class ZoneStateError(ZNSError):
    """Operation illegal in the zone's current state."""


class OutOfBoundsError(ZNSError):
    """Read beyond the write pointer / zone capacity."""


class ZoneState(enum.Enum):
    EMPTY = "empty"
    OPEN = "open"           # implicitly opened by a first append
    FULL = "full"           # write pointer reached capacity or host FINISHed
    READ_ONLY = "read_only" # host transitioned (e.g. sealed checkpoint zone)
    OFFLINE = "offline"     # dead zone (injected for fault-tolerance tests)


@dataclass
class Zone:
    """Descriptor for one zone (mirrors the ZNS Zone Descriptor)."""

    zone_id: int
    start_lba: int            # first block of the zone in device LBA space
    capacity_blocks: int      # writable blocks in the zone
    write_pointer: int = 0    # next writable block, relative to start_lba
    state: ZoneState = ZoneState.EMPTY
    # Number of times this zone has been reset (wear proxy; the paper's GC
    # statistics build on host-visible reset counts).
    reset_count: int = 0
    cond: threading.Condition = field(
        default_factory=threading.Condition, repr=False, compare=False
    )
    # Virtual-time I/O queue at ZONE granularity: transfers against one zone
    # retire behind each other (one flash die), transfers against different
    # zones of the same device overlap — the intra-device parallelism real
    # ZNS hardware exposes (arXiv:2310.19094). ``io_busy_until`` is the
    # monotonic instant the zone's die goes idle; a new transfer's completion
    # deadline is max(now, io_busy_until) + service, and the clock advances
    # to that deadline — the old ``io_gate`` sleep-under-lock semantics with
    # no thread parked per transfer.
    io_busy_until: float = 0.0
    io_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    # tail of the zone's timed-transfer chain (see IoFuture._prev): keeps
    # already-due submissions from retiring ahead of an in-flight predecessor.
    # A WEAK reference — in-flight futures are strongly held by the reactor
    # heap/submitter, and a retired tail must not pin its payload value until
    # the zone's next transfer arrives.
    io_tail: Optional[weakref.ref] = field(
        default=None, repr=False, compare=False
    )

    @property
    def remaining_blocks(self) -> int:
        return self.capacity_blocks - self.write_pointer

    @property
    def is_writable(self) -> bool:
        return self.state in (ZoneState.EMPTY, ZoneState.OPEN)


_DEV_SEQ = itertools.count()  # stable per-process device ordinals for traces


class ZonedDevice:
    """An emulated ZNS SSD: ``num_zones`` zones of ``zone_blocks`` blocks of
    ``block_bytes`` bytes.

    Defaults follow the paper's evaluation: 4 KiB blocks and 256 MiB zones
    (65536 blocks/zone).
    """

    def __init__(
        self,
        num_zones: int = 8,
        zone_bytes: int = 256 * 1024 * 1024,
        block_bytes: int = 4096,
        backing_file: Optional[Path | str] = None,
        read_us_per_block: float = 0.0,
        append_us_per_block: float = 0.0,
        max_open_zones: int = 0,  # 0 = unlimited (QEMU default)
        reactor: Optional[IoReactor] = None,
        fault_injector=None,
        fault_key=None,
        retry_policy: Optional[RetryPolicy] = None,
    ):
        if zone_bytes % block_bytes != 0:
            raise ValueError("zone_bytes must be a multiple of block_bytes")
        self.num_zones = int(num_zones)
        self.block_bytes = int(block_bytes)
        self.zone_blocks = int(zone_bytes // block_bytes)
        self.zone_bytes = int(zone_bytes)
        self.read_us_per_block = float(read_us_per_block)
        self.append_us_per_block = float(append_us_per_block)
        self.max_open_zones = int(max_open_zones)
        # all devices share one process-wide reactor by default: a single
        # thread retires every emulated in-flight transfer, like an NVMe CQ
        self.reactor = reactor if reactor is not None else IoReactor.default()
        self._lock = threading.RLock()

        total_bytes = self.num_zones * self.zone_bytes
        if backing_file is not None:
            path = Path(backing_file)
            mode = "r+" if path.exists() and path.stat().st_size == total_bytes else "w+"
            self._buf = np.memmap(path, dtype=np.uint8, mode=mode, shape=(total_bytes,))
            self._backing_file = path
        else:
            self._buf = np.zeros(total_bytes, dtype=np.uint8)
            self._backing_file = None

        self.zones = [
            Zone(zone_id=z, start_lba=z * self.zone_blocks,
                 capacity_blocks=self.zone_blocks)
            for z in range(self.num_zones)
        ]
        # device-level statistics (host-visible, like NVMe log pages);
        # bytes_copied/bytes_viewed account host-side data movement: the copy
        # path duplicates the extent into host memory, the view path hands out
        # an alias of the backing buffer (zero host copies). Backed by the
        # telemetry registry — devices exist in unbounded numbers (tests make
        # thousands), so each owns a PRIVATE registry rather than polluting
        # the process-global one; ``stats`` keeps the legacy dict shape.
        self.dev_ordinal = next(_DEV_SEQ)
        self._devname = f"dev{self.dev_ordinal}"
        self.metrics = MetricsRegistry(f"dev{self.dev_ordinal}")
        self._c_blocks_read = self.metrics.counter("blocks_read")
        self._c_blocks_appended = self.metrics.counter("blocks_appended")
        self._c_zone_resets = self.metrics.counter("zone_resets")
        self._c_zone_finishes = self.metrics.counter("zone_finishes")
        self._c_bytes_copied = self.metrics.counter("bytes_copied")
        self._c_bytes_viewed = self.metrics.counter("bytes_viewed")
        # SMART-style error/transition counters: protocol+media errors per
        # direction and host-visible zone degradations — the raw attributes
        # DeviceHealthMonitor reads to compute the composite status.
        self._c_read_errors = self.metrics.counter("read_errors")
        self._c_append_errors = self.metrics.counter("append_errors")
        self._c_zone_ro_transitions = self.metrics.counter(
            "zone_readonly_transitions")
        self._c_zone_off_transitions = self.metrics.counter(
            "zone_offline_transitions")
        # Transient-fault accounting, deliberately SEPARATE from the hard
        # read/append error counters: an injected media error that a retry
        # absorbs is a soft signal (SUSPECT at worst), only an exhausted
        # retry budget escalates into read_errors/append_errors and the
        # degraded/rebuild pipeline.
        self._c_retries = self.metrics.counter("retries")
        self._c_io_timeouts = self.metrics.counter("io_timeouts")
        self._c_faults_injected = self.metrics.counter("faults_injected")
        self.stats = StatsView({
            "blocks_read": self._c_blocks_read,
            "blocks_appended": self._c_blocks_appended,
            "zone_resets": self._c_zone_resets,
            "zone_finishes": self._c_zone_finishes,
            "bytes_copied": self._c_bytes_copied,
            "bytes_viewed": self._c_bytes_viewed,
            "read_errors": self._c_read_errors,
            "append_errors": self._c_append_errors,
            "retries": self._c_retries,
            "io_timeouts": self._c_io_timeouts,
            "faults_injected": self._c_faults_injected,
        })
        # Service/queue-wait distributions for emulated (timed) transfers
        # only — the zero-service fast path stays metric-free.
        self._h_read_service = self.metrics.histogram("read.service_seconds")
        self._h_read_wait = self.metrics.histogram("read.wait_seconds")
        self._h_append_service = self.metrics.histogram("append.service_seconds")
        self._h_append_wait = self.metrics.histogram("append.wait_seconds")
        # Fault-injection wiring (see repro_torch.faults): when either knob is set
        # the submit paths take the retrying/faulty branch; with both unset
        # every path below is byte-for-byte the legacy fast path.
        self.fault_injector = fault_injector
        self.fault_key = fault_key if fault_key is not None else self.dev_ordinal
        self.retry_policy = retry_policy
        # append listeners: ``fn(device, zone_id, start_rel, nblocks, fut)``
        # called at submission, BEFORE the future can retire — the crash
        # harness journals durable appends by attaching done-callbacks here.
        self._append_listeners: list = []

    def add_append_listener(self, fn) -> None:
        """Observe every async append submission: ``fn(device, zone_id,
        start_rel, nblocks, fut)`` runs after the data effect lands and
        before the completion can retire, so a listener's done-callback on
        ``fut`` fires ahead of any caller-attached callback."""
        self._append_listeners.append(fn)

    @property
    def _faulty(self) -> bool:
        return self.fault_injector is not None or self.retry_policy is not None

    # ------------------------------------------------------------------ zones
    def zone(self, zone_id: int) -> Zone:
        if not 0 <= zone_id < self.num_zones:
            raise OutOfBoundsError(f"zone {zone_id} out of range [0,{self.num_zones})")
        return self.zones[zone_id]

    def report_zones(self) -> list[Zone]:
        """ZNS 'Zone Management Receive / Report Zones'."""
        return list(self.zones)

    def open_zones(self) -> list[Zone]:
        return [z for z in self.zones if z.state == ZoneState.OPEN]

    # ----------------------------------------------------------------- append
    def _do_append(self, zone_id: int, data: np.ndarray | bytes) -> tuple[Zone, int, int]:
        """The append data effect under the device lock: state machine checks,
        buffer write, write-pointer advance. Returns (zone, start_rel, nblocks).
        Timing (the emulated transfer) is layered on by the callers."""
        raw = payload_as_uint8(data)
        nblocks = -(-raw.size // self.block_bytes)  # ceil
        with self._lock:
            z = self.zone(zone_id)
            if z.state == ZoneState.EMPTY:
                if self.max_open_zones and len(self.open_zones()) >= self.max_open_zones:
                    self._c_append_errors.inc()
                    raise ZoneStateError("max open zones exceeded")
                z.state = ZoneState.OPEN
            if not z.is_writable:
                self._c_append_errors.inc()
                raise ZoneStateError(f"zone {zone_id} not writable (state={z.state})")
            if nblocks > z.remaining_blocks:
                self._c_append_errors.inc()
                raise ZoneFullError(
                    f"append of {nblocks} blocks exceeds zone {zone_id} "
                    f"remaining {z.remaining_blocks}"
                )
            start_rel = z.write_pointer
            off = (z.start_lba + start_rel) * self.block_bytes
            self._buf[off : off + raw.size] = raw
            pad = nblocks * self.block_bytes - raw.size
            if pad:
                self._buf[off + raw.size : off + raw.size + pad] = 0
            z.write_pointer += nblocks
            if z.write_pointer == z.capacity_blocks:
                z.state = ZoneState.FULL
            self._c_blocks_appended.inc(nblocks)
            return z, start_rel, nblocks

    def _do_append_torn(self, zone_id: int, data: np.ndarray | bytes,
                        keep_frac: float) -> tuple[Zone, int, int, int]:
        """Torn-append data effect: the command claimed ``nblocks`` but only
        a prefix of ``kept`` blocks reached the media before it failed — the
        write pointer advances by ``kept`` and the zone is left
        host-indeterminate, exactly the anomaly the crash/fencing machinery
        exists to contain. Same protocol checks as :meth:`_do_append` (a
        torn append is a *media* fault layered on a legal command). Returns
        ``(zone, start_rel, nblocks, kept)``."""
        raw = payload_as_uint8(data)
        nblocks = -(-raw.size // self.block_bytes)  # ceil
        with self._lock:
            z = self.zone(zone_id)
            if z.state == ZoneState.EMPTY:
                if self.max_open_zones and len(self.open_zones()) >= self.max_open_zones:
                    self._c_append_errors.inc()
                    raise ZoneStateError("max open zones exceeded")
                z.state = ZoneState.OPEN
            if not z.is_writable:
                self._c_append_errors.inc()
                raise ZoneStateError(f"zone {zone_id} not writable (state={z.state})")
            if nblocks > z.remaining_blocks:
                self._c_append_errors.inc()
                raise ZoneFullError(
                    f"append of {nblocks} blocks exceeds zone {zone_id} "
                    f"remaining {z.remaining_blocks}"
                )
            kept = min(nblocks - 1, max(1, int(round(nblocks * keep_frac))))
            start_rel = z.write_pointer
            off = (z.start_lba + start_rel) * self.block_bytes
            nbytes = min(raw.size, kept * self.block_bytes)
            self._buf[off : off + nbytes] = raw[:nbytes]
            z.write_pointer += kept
            self._c_blocks_appended.inc(kept)
            return z, start_rel, nblocks, kept

    def zone_append(self, zone_id: int, data: np.ndarray | bytes) -> int:
        """ZNS 'Zone Append': write ``data`` at the zone's write pointer.

        ``data`` must be a whole number of blocks (the device pads the final
        block with zeros, as a ZNS host library would). Returns the starting
        block index *relative to the zone* at which data landed. Synchronous:
        blocks for the emulated transfer time; the async path is
        :meth:`submit_append`.
        """
        if self._faulty:
            # the sync shim over the faulty async path: same injector
            # consultation, same retry/timeout behavior as submit_append
            return self.submit_append(zone_id, data).result()
        with self._lock:
            z, start_rel, nblocks = self._do_append(zone_id, data)
            deadline, service = self._claim_slot(
                z, nblocks, self.append_us_per_block, op="append")
        self._sleep_until(deadline, service)
        return start_rel

    def submit_append(self, zone_id: int, data: np.ndarray | bytes, *,
                      ring: Optional[CompletionRing] = None) -> IoFuture:
        """Asynchronous Zone Append: the write lands immediately (metadata and
        bytes, under the device lock), the returned future retires at the
        zone's emulated completion deadline with the landing block as its
        value — real ZNS Zone Append also reports the assigned LBA only in
        the completion entry. ``fut.submitted_block`` exposes the landing
        block synchronously for emulation-internal consumers (stripe desync
        checks)."""
        if self._faulty:
            return self._submit_append_faulty(zone_id, data, ring=ring)
        with self._lock:
            z, start_rel, nblocks = self._do_append(zone_id, data)
            fut = IoFuture(op="append", zone_id=zone_id, block_off=start_rel,
                           nblocks=nblocks, ring=ring)
            fut.submitted_block = start_rel
            fut._value = start_rel
            fut.device = self._devname
            deadline, service = self._claim_slot(
                z, nblocks, self.append_us_per_block, fut, op="append")
            fut.service_seconds = service
        for fn in self._append_listeners:
            fn(self, zone_id, start_rel, nblocks, fut)
        return self.reactor.schedule(fut, deadline)

    # ------------------------------------------------- fault-injected paths
    def _fault_hooks(self, op: str, zone_id: int, err_counter):
        """Build the retry controller's ``on_*`` hooks for one logical op:
        soft-counter increments plus ``io.*`` events tagged with the
        device's stable fault key (``member``), published outside any lock
        (the hooks run as completion/timer callbacks)."""
        dev = self._devname
        member = self.fault_key

        def on_retry(attempt, err):
            self._c_retries.inc()
            _publish_event(
                "io.retry", severity=_Sev.WARNING,
                message=f"{dev} {op} zone {zone_id} attempt {attempt} "
                        f"failed ({type(err).__name__}); retrying",
                device=dev, member=member, zone=zone_id, op=op,
                attempt=attempt, error=type(err).__name__)

        def on_timeout(attempt, err):
            self._c_io_timeouts.inc()
            _publish_event(
                "io.timeout", severity=_Sev.ERROR,
                message=f"{dev} {op} zone {zone_id} attempt {attempt} "
                        f"exceeded its timeout budget",
                device=dev, member=member, zone=zone_id, op=op,
                attempt=attempt)

        def on_exhausted(attempt, err):
            err_counter.inc()
            _publish_event(
                "io.retry_exhausted", severity=_Sev.ERROR,
                message=f"{dev} {op} zone {zone_id} gave up after "
                        f"{attempt} attempt(s): {type(err).__name__}",
                device=dev, member=member, zone=zone_id, op=op,
                attempt=attempt, error=type(err).__name__)

        def timeout_error(attempt):
            return IoTimeoutError(
                f"{op} on {dev} zone {zone_id} attempt {attempt} exceeded "
                f"its timeout budget", op=op, device=dev, zone_id=zone_id,
                attempt=attempt)

        return on_retry, on_timeout, on_exhausted, timeout_error

    def _submit_read_faulty(self, zone_id: int, block_off: int, nblocks: int,
                            *, dtype=None, copy: bool = False,
                            ring: Optional[CompletionRing] = None) -> IoFuture:
        """submit_read with the injector/retry machinery engaged: every
        attempt re-snapshots the span, consults the injector, and stages a
        value OR an error completion on its attempt future; the caller sees
        one aggregate future the retry controller resolves."""
        inj = self.fault_injector
        policy = self.retry_policy or _SINGLE_ATTEMPT
        dev = self._devname
        key = self.fault_key
        agg = IoFuture(op="read", zone_id=zone_id, block_off=block_off,
                       nblocks=nblocks, ring=ring)
        agg.device = dev

        def submit_attempt(attempt: int) -> Optional[IoFuture]:
            with self._lock:
                z, span = self._read_span(zone_id, block_off, nblocks,
                                          copy=copy)
                if dtype is not None:
                    span = span.view(dtype)
                d = inj.decide(key, "read", zone_id, nblocks,
                               retry=attempt > 1) if inj else _NO_FAULT
                if d.kind is not None or d.extra_latency_s:
                    self._c_faults_injected.inc()
                if d.kind == "hang":
                    return None       # completion lost; only a timeout helps
                fut = IoFuture(op="read", zone_id=zone_id,
                               block_off=block_off, nblocks=nblocks)
                fut.device = dev
                if d.kind is not None:
                    fut._error = TransientIOError(
                        f"injected media error: read {dev} zone {zone_id} "
                        f"attempt {attempt}", op="read", device=dev,
                        zone_id=zone_id, attempt=attempt)
                else:
                    fut._value = span
                deadline, service = self._claim_slot(
                    z, nblocks, self.read_us_per_block, fut,
                    extra_s=d.extra_latency_s)
                fut.service_seconds = service
            return self.reactor.schedule(fut, deadline)

        on_retry, on_timeout, on_exhausted, timeout_error = \
            self._fault_hooks("read", zone_id, self._c_read_errors)
        jitter = (lambda: inj.jitter01(key, "read")) if inj \
            else (lambda: 0.5)
        first = (submit_attempt(1),)  # protocol errors raise synchronously,
        return drive_retries(         # exactly like the fault-free path
            agg, policy=policy, reactor=self.reactor, submit=submit_attempt,
            jitter01=jitter, on_retry=on_retry, on_timeout=on_timeout,
            on_exhausted=on_exhausted, timeout_error=timeout_error,
            first=first)

    def _submit_append_faulty(self, zone_id: int, data, *,
                              ring: Optional[CompletionRing] = None) -> IoFuture:
        """submit_append with the injector/retry machinery engaged.

        The data effect happens exactly ONCE, at the first submission, under
        the device lock — an injected media error is a *completion status*
        (the payload landed; the device reported failure), so a retry only
        replays the completion for the same landing block. A torn append
        lands a prefix and fails with the non-retryable
        :class:`TornAppendError`; a hung append lands its payload but its
        completion never arrives."""
        inj = self.fault_injector
        policy = self.retry_policy or _SINGLE_ATTEMPT
        dev = self._devname
        key = self.fault_key
        raw = payload_as_uint8(data)
        est = -(-raw.size // self.block_bytes)  # ceil

        with self._lock:
            d = inj.decide(key, "append", zone_id, est) if inj else _NO_FAULT
            if d.kind is not None or d.extra_latency_s:
                self._c_faults_injected.inc()
            deadline = 0.0
            if d.kind == "torn":
                z, start_rel, nblocks, kept = self._do_append_torn(
                    zone_id, raw, d.torn_keep)
                first_fut = IoFuture(op="append", zone_id=zone_id,
                                     block_off=start_rel, nblocks=nblocks)
                first_fut.device = dev
                first_fut._error = TornAppendError(
                    f"injected torn append: {dev} zone {zone_id} landed "
                    f"{kept}/{nblocks} blocks", op="append", device=dev,
                    zone_id=zone_id)
                deadline, service = self._claim_slot(
                    z, kept, self.append_us_per_block, first_fut,
                    op="append", extra_s=d.extra_latency_s)
                first_fut.service_seconds = service
            else:
                z, start_rel, nblocks = self._do_append(zone_id, raw)
                if d.kind == "hang":
                    first_fut = None   # payload durable; completion lost
                else:
                    first_fut = IoFuture(op="append", zone_id=zone_id,
                                         block_off=start_rel, nblocks=nblocks)
                    first_fut.device = dev
                    if d.kind is not None:
                        first_fut._error = TransientIOError(
                            f"injected media error: append {dev} zone "
                            f"{zone_id} attempt 1", op="append", device=dev,
                            zone_id=zone_id, attempt=1)
                    else:
                        first_fut._value = start_rel
                    deadline, service = self._claim_slot(
                        z, nblocks, self.append_us_per_block, first_fut,
                        op="append", extra_s=d.extra_latency_s)
                    first_fut.service_seconds = service
            agg = IoFuture(op="append", zone_id=zone_id, block_off=start_rel,
                           nblocks=nblocks, ring=ring)
            agg.device = dev
            agg.submitted_block = start_rel
        for fn in self._append_listeners:
            fn(self, zone_id, start_rel, nblocks, agg)
        if first_fut is not None:
            self.reactor.schedule(first_fut, deadline)

        def submit_attempt(attempt: int) -> Optional[IoFuture]:
            # the payload is already durable at start_rel (the ZNS append
            # data effect is once-only); a retry replays the completion
            d = inj.decide(key, "append", zone_id, nblocks,
                           retry=True) if inj else _NO_FAULT
            if d.kind is not None or d.extra_latency_s:
                self._c_faults_injected.inc()
            if d.kind == "hang":
                return None
            z = self.zone(zone_id)
            fut = IoFuture(op="append", zone_id=zone_id, block_off=start_rel,
                           nblocks=nblocks)
            fut.device = dev
            if d.kind is not None:
                fut._error = TransientIOError(
                    f"injected media error: append {dev} zone {zone_id} "
                    f"attempt {attempt}", op="append", device=dev,
                    zone_id=zone_id, attempt=attempt)
            else:
                fut._value = start_rel
            deadline, service = self._claim_slot(
                z, nblocks, self.append_us_per_block, fut, op="append",
                extra_s=d.extra_latency_s)
            fut.service_seconds = service
            return self.reactor.schedule(fut, deadline)

        on_retry, on_timeout, on_exhausted, timeout_error = \
            self._fault_hooks("append", zone_id, self._c_append_errors)
        jitter = (lambda: inj.jitter01(key, "append")) if inj \
            else (lambda: 0.5)
        return drive_retries(
            agg, policy=policy, reactor=self.reactor, submit=submit_attempt,
            jitter01=jitter, on_retry=on_retry, on_timeout=on_timeout,
            on_exhausted=on_exhausted, timeout_error=timeout_error,
            first=(first_fut,))

    # ------------------------------------------------------------------- read
    def _claim_slot(self, z: Zone, nblocks: int, us_per_block: float,
                    fut: Optional[IoFuture] = None,
                    op: str = "read", extra_s: float = 0.0) -> tuple[float, float]:
        """Reserve this transfer's slot in the zone's virtual-time queue.

        Returns ``(completion_deadline, service_seconds)``. Same-zone
        transfers get non-decreasing deadlines (they queue behind one die);
        different zones advance independent clocks (they overlap). A
        zero-service transfer on an idle zone costs nothing and completes
        inline; on a busy zone it still queues behind the in-flight work.
        When ``fut`` is given it is linked behind the zone's previous timed
        transfer, so completions of one zone retire strictly in submission
        order even when the reactor lags wall-clock.

        Callers claim while still holding the device lock (the same critical
        section that landed the data / snapshotted the read span), so a
        zone's virtual-time order can never invert against its data order —
        two racing appends complete in the order their bytes landed.
        ``extra_s`` adds an injected latency spike to the service time (it
        occupies the zone's die like real slow media would).
        """
        service = nblocks * us_per_block * 1e-6 + extra_s
        if not service and not z.io_busy_until:
            return 0.0, 0.0            # non-emulated fast path: no lock
        now = time.monotonic()
        with z.io_lock:
            start = max(now, z.io_busy_until)
            deadline = start + service
            z.io_busy_until = deadline
            if fut is not None:
                fut._prev = z.io_tail() if z.io_tail is not None else None
                z.io_tail = weakref.ref(fut)
        if op == "read":
            self._h_read_service.observe(service)
            self._h_read_wait.observe(start - now)
        else:
            self._h_append_service.observe(service)
            self._h_append_wait.observe(start - now)
        if _trace.enabled():
            # Device VIRTUAL time: the transfer occupies the zone's die for
            # [start, start+service) on the monotonic clock — emit it now,
            # before it elapses, onto the device's own trace track.
            _trace.event_complete(
                f"dev.{op}", start, service,
                track=f"dev{self.dev_ordinal}/z{z.zone_id}",
                zone=z.zone_id, nblocks=nblocks,
                wait_us=round((start - now) * 1e6, 1))
        return deadline, service

    @staticmethod
    def _sleep_until(deadline: float, service: float) -> None:
        """Synchronous tail of a transfer: sleep (no lock held) until the
        claimed completion deadline — the blocking shim over the same clock
        the reactor-backed submit paths use, so sync and async transfers
        against one zone serialize with each other."""
        if service:
            delay = deadline - time.monotonic()
            if delay > 0:
                time.sleep(delay)

    def _read_span(self, zone_id: int, block_off: int, nblocks: int,
                   *, copy: bool) -> tuple[Zone, np.ndarray]:
        """Bounds-check a read and return (zone, buffer) under ONE lock
        acquisition: an owned copy (``copy=True``, atomic w.r.t. writers) or
        a read-only view of the backing buffer. Byte accounting happens here
        too, so the hot path never re-takes the lock."""
        with self._lock:
            z = self.zone(zone_id)
            if z.state == ZoneState.OFFLINE:
                self._c_read_errors.inc()
                raise ZoneStateError(f"zone {zone_id} is offline")
            if block_off < 0 or nblocks < 0 or block_off + nblocks > z.write_pointer:
                self._c_read_errors.inc()
                raise OutOfBoundsError(
                    f"read [{block_off},{block_off + nblocks}) beyond write pointer "
                    f"{z.write_pointer} of zone {zone_id}"
                )
            off = (z.start_lba + block_off) * self.block_bytes
            span = self._buf[off : off + nblocks * self.block_bytes]
            self._c_blocks_read.inc(nblocks)
            if copy:
                span = np.array(span)
                self._c_bytes_copied.inc(span.nbytes)
            else:
                span = span.view()
                span.flags.writeable = False
                self._c_bytes_viewed.inc(span.nbytes)
            return z, span

    def read_blocks(self, zone_id: int, block_off: int, nblocks: int) -> np.ndarray:
        """Read ``nblocks`` blocks starting at ``block_off`` (zone-relative).

        Bounds-checked against the write pointer: reading unwritten blocks is
        a protocol error (this is the check the offloaded program's
        ``bpf_read`` hook relies on). Returns an owned COPY taken under the
        device lock (atomic even against a host that resets and rewrites the
        zone mid-read); the offload hot path uses :meth:`read_blocks_view` /
        :meth:`read_extent` instead.
        """
        if self._faulty:
            return self.submit_read(zone_id, block_off, nblocks,
                                    copy=True).result()
        with self._lock:
            z, out = self._read_span(zone_id, block_off, nblocks, copy=True)
            deadline, service = self._claim_slot(
                z, nblocks, self.read_us_per_block)
        self._sleep_until(deadline, service)
        return out

    def read_blocks_view(self, zone_id: int, block_off: int, nblocks: int) -> np.ndarray:
        """Zero-copy variant of :meth:`read_blocks`: returns a read-only uint8
        VIEW of the device's backing buffer.

        The view stays valid as long as the extent is not rewritten (zones are
        append-only, so written blocks only change across a host-driven
        ``reset_zone`` — rewriting an extent while a reader holds it is a
        host protocol bug, exactly as it would be on real hardware).
        Consumers that feed XLA hand this view straight to the executable —
        the device-internal DMA the paper models, with at most the one copy
        XLA itself makes on device_put.
        """
        if self._faulty:
            return self.submit_read(zone_id, block_off, nblocks,
                                    copy=False).result()
        with self._lock:
            z, view = self._read_span(zone_id, block_off, nblocks, copy=False)
            deadline, service = self._claim_slot(
                z, nblocks, self.read_us_per_block)
        self._sleep_until(deadline, service)
        return view

    def submit_read(self, zone_id: int, block_off: int, nblocks: int, *,
                    dtype: Optional[np.dtype | str] = None, copy: bool = False,
                    ring: Optional[CompletionRing] = None) -> IoFuture:
        """Asynchronous read: enqueue a transfer descriptor and return an
        :class:`~repro_torch.zns.ring.IoFuture` that retires at the zone's emulated
        completion deadline with the extent as its value — a read-only view
        of the backing buffer by default (``copy=True`` for an owned copy),
        reinterpreted as ``dtype`` elements when given.

        The bounds check and buffer slice happen at submission under the
        device lock; zones are append-only, so the snapshot cannot change
        before the completion retires (rewriting an extent under an in-flight
        read is a host protocol bug, as on real hardware). One reactor thread
        drives any number of these in flight — in-flight depth is bounded by
        the emulated device, not by a thread pool.
        """
        if dtype is not None:
            dtype = block_aligned_dtype(self.block_bytes, dtype)
        if self._faulty:
            return self._submit_read_faulty(zone_id, block_off, nblocks,
                                            dtype=dtype, copy=copy, ring=ring)
        with self._lock:
            z, span = self._read_span(zone_id, block_off, nblocks, copy=copy)
            if dtype is not None:
                span = span.view(dtype)
            fut = IoFuture(op="read", zone_id=zone_id, block_off=block_off,
                           nblocks=nblocks, ring=ring)
            fut._value = span
            fut.device = self._devname
            deadline, service = self._claim_slot(
                z, nblocks, self.read_us_per_block, fut)
            fut.service_seconds = service
        return self.reactor.schedule(fut, deadline)

    def read_extent(self, zone_id: int, block_off: int, nblocks: int,
                    dtype: np.dtype | str) -> np.ndarray:
        """Dtype-typed zero-copy read: :meth:`read_blocks_view` reinterpreted
        as ``dtype`` elements. Block offsets are always block-aligned in the
        backing buffer, which is stricter than any supported element
        alignment, so the reinterpretation never copies."""
        dtype = block_aligned_dtype(self.block_bytes, dtype)
        return self.read_blocks_view(zone_id, block_off, nblocks).view(dtype)

    def read_zone(self, zone_id: int) -> np.ndarray:
        """Read every written block of a zone."""
        z = self.zone(zone_id)
        return self.read_blocks(zone_id, 0, z.write_pointer)

    # -------------------------------------------------------- zone management
    def finish_zone(self, zone_id: int) -> None:
        """ZNS 'Zone Management Send / Finish': host seals the zone."""
        with self._lock:
            z = self.zone(zone_id)
            if z.state not in (ZoneState.EMPTY, ZoneState.OPEN, ZoneState.FULL):
                raise ZoneStateError(f"cannot finish zone in state {z.state}")
            z.state = ZoneState.FULL
            self._c_zone_finishes.inc()

    def set_read_only(self, zone_id: int) -> None:
        with self._lock:
            z = self.zone(zone_id)
            changed = z.state is not ZoneState.READ_ONLY
            z.state = ZoneState.READ_ONLY
            if changed:
                self._c_zone_ro_transitions.inc()
        if changed:
            # outside the device lock: event subscribers may re-enter the
            # device (a dashboard polling report_zones must not deadlock)
            _publish_event(
                "zone.read_only", severity=_Sev.WARNING,
                message=f"dev{self.dev_ordinal} zone {zone_id} -> READ_ONLY",
                device=f"dev{self.dev_ordinal}", zone=zone_id)

    def reset_zone(self, zone_id: int) -> None:
        """ZNS 'Zone Management Send / Reset': host-managed GC.

        All data in the zone is discarded and the write pointer rewinds to 0.
        This is the paper's host-visible garbage-collection primitive.
        """
        with self._lock:
            z = self.zone(zone_id)
            if z.state == ZoneState.OFFLINE:
                raise ZoneStateError(f"zone {zone_id} is offline")
            z.write_pointer = 0
            z.state = ZoneState.EMPTY
            z.reset_count += 1
            self._c_zone_resets.inc()

    def set_offline(self, zone_id: int, *, quiet: bool = False) -> None:
        """Fault injection: mark a zone dead (used by fault-tolerance tests).

        ``quiet=True`` marks the zone OFFLINE as a *placeholder* — the array
        manager parks a hot spare's zones this way until rebuild delivers
        their data — so neither the SMART ``zone_offline_transitions``
        counter nor the ``zone.offline`` event fires: the spare did not
        fail, it just must not serve reads it does not hold yet."""
        with self._lock:
            z = self.zone(zone_id)
            changed = z.state is not ZoneState.OFFLINE
            z.state = ZoneState.OFFLINE
            if changed and not quiet:
                self._c_zone_off_transitions.inc()
        if changed and not quiet:
            _publish_event(
                "zone.offline", severity=_Sev.ERROR,
                message=f"dev{self.dev_ordinal} zone {zone_id} -> OFFLINE",
                device=f"dev{self.dev_ordinal}", zone=zone_id)

    def revive_zone(self, zone_id: int) -> None:
        """Bring an OFFLINE zone back as EMPTY with a rewound write pointer —
        the media-replacement primitive rebuild-to-spare needs (the spare's
        placeholder zones are revived one at a time as reconstruction
        reaches them). Only OFFLINE zones revive: any other state holds live
        protocol state a silent rewind would corrupt."""
        with self._lock:
            z = self.zone(zone_id)
            if z.state is not ZoneState.OFFLINE:
                raise ZoneStateError(
                    f"zone {zone_id} not offline (state={z.state}): only "
                    f"offline zones can be revived")
            z.write_pointer = 0
            z.state = ZoneState.EMPTY

    # ------------------------------------------------------------------ misc
    def flush(self) -> None:
        if self._backing_file is not None:
            self._buf.flush()

    @property
    def lba_size(self) -> int:
        """Block size in bytes (the ``bpf_get_lba_size`` hook's answer)."""
        return self.block_bytes

    def utilization(self) -> float:
        written = sum(z.write_pointer for z in self.zones)
        return written / float(self.num_zones * self.zone_blocks)
