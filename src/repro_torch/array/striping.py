"""Zone striping with redundancy over multiple ZNS devices.

The paper defers multi-device operation as future work; real CSD deployments
aggregate many devices behind one logical address space — and must survive a
member failure. A :class:`StripedZoneArray` presents N identical
:class:`~repro_torch.zns.ZonedDevice` members as ONE logical zoned device in one of
three redundancy modes:

  * ``raid0`` (default) — pure striping: logical chunk ``k`` (column
    ``k % C``, row ``k // C``) lives on member ``k % N`` at member-local
    offset ``row * stripe_blocks``; a member-zone failure kills the logical
    zone (the clean-error path PR 2 tested);
  * ``raid1`` — mirrored stripe groups: members pair up into ``N/2`` columns
    and each chunk lands on BOTH partners of its column. Healthy reads
    round-robin the mirror pair by stripe row (up to ~2x aggregate read
    bandwidth); with one partner OFFLINE every read redirects to the
    survivor — bit-identical, no reconstruction math;
  * ``xor`` — RAID-5-style rotating parity: ``N-1`` data chunks per stripe
    row plus one XOR parity chunk on the rotating parity member. A dead
    member's chunk is reconstructed by XOR-ing the surviving row members;
    the parity chunk of the (at most one) incomplete tail row has not landed
    yet, so a host-side parity accumulator (the NVRAM parity buffer of a
    real RAID controller) stands in for it.

Shared invariants, every mode:

  * appends and reads preserve ZNS semantics end-to-end — member appends
    land exactly at each member's write pointer, the logical zone state
    machine is derived from the members', and the logical write pointer
    advances only once every member submission of an append has landed;
  * member transfers fan out as in-flight completion-ring descriptors
    (:mod:`repro_torch.zns.ring`): an N-member read holds N reactor slots and ZERO
    worker threads, and degraded-read reconstruction rides the SAME reactor
    clocks — survivor reads are ordinary member transfers, the XOR combine
    runs at completion time (off the reactor pump, on the gather pool);
  * a member failing mid-fan-out can never orphan the aggregate future:
    already-submitted member completions settle a barrier that retires the
    aggregate with the error (and a torn append fences the zone READ_ONLY).

The class is a drop-in for ``ZonedDevice`` everywhere the repo consumes one
(``NvmCsd``, ``ZoneDataStore``, ``ZonedCheckpointStore``): a 1-member raid0
array is the degenerate single-device path.
"""
from __future__ import annotations

import atexit
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.telemetry import trace as _trace
from repro_torch.telemetry.events import Severity as _Sev, publish as _publish_event
from repro_torch.telemetry.metrics import MetricsRegistry, registry as _registry
from repro_torch.zns.device import (
    OutOfBoundsError,
    ZNSError,
    ZonedDevice,
    ZoneFullError,
    ZoneState,
    ZoneStateError,
    block_aligned_dtype,
    payload_as_uint8,
)
from repro_torch.zns.ring import (
    CompletionBarrier,
    CompletionRing,
    IoFuture,
    in_reactor_thread,
)

__all__ = ["StripedZoneArray", "LogicalZone", "StripeChunk",
           "REDUNDANCY_MODES", "coalesce_member_runs"]

REDUNDANCY_MODES = ("raid0", "raid1", "xor")


class _GatherPool:
    """Bounded pool of DAEMON threads for gather-interleave / XOR-combine
    memcpys of reactor-retired member reads.

    The reactor must stay a pointer-moving completion pump (a pair of
    concurrent 64 MiB striped reads would otherwise serialize ~100 MiB of
    memcpy ahead of every other due completion in the process), so heavy
    completion work lands here. ``concurrent.futures.ThreadPoolExecutor``
    workers are non-daemonic — they outlive test teardown and stall
    interpreter exit until the global ``_python_exit`` join — so this
    minimal replacement mirrors the reactor's lifecycle handling
    (:mod:`repro_torch.zns.ring`): lazily-spawned daemon workers plus an atexit
    shutdown. Bounded and shared — threads scale with concurrent gathers in
    progress, never with in-flight transfers, so the ring model's claim
    stands.
    """

    def __init__(self, max_workers: int = 4):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._max = max_workers
        self._closed = False

    def submit(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if not self._closed:
                _registry().counter("gather.jobs").inc()
                self._q.put((fn, time.monotonic()))
                if len(self._threads) < self._max:
                    t = threading.Thread(
                        target=self._work, daemon=True,
                        name=f"stripe-gather-{len(self._threads)}")
                    self._threads.append(t)
                    t.start()
                return
        # pool already shut down (interpreter exit): run inline rather than
        # drop the gather — its barrier slot MUST settle or a caller blocked
        # in result() with no timeout would hang forever
        fn()

    def _work(self) -> None:
        # queue-wait vs execute split is THE scaling-cliff discriminator for
        # this pool: growing wait with flat exec means the 4 workers (or the
        # queue hand-off) are the serialization point, not the memcpys
        reg = _registry()
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, t_submit = item
            t0 = time.monotonic()
            reg.histogram("gather.queue_wait_seconds").observe(t0 - t_submit)
            try:
                with _trace.span("gather.exec"):
                    fn()
            except Exception:
                pass  # gather closures settle their barrier slot themselves
            reg.histogram("gather.exec_seconds").observe(
                time.monotonic() - t0)

    def shutdown(self, timeout: float = 1.0) -> None:
        """Drain the workers (atexit): daemon threads would not block exit,
        but an orderly stop keeps in-flight gathers from dying mid-memcpy."""
        with self._lock:
            self._closed = True
            threads = list(self._threads)
        for _ in threads:
            self._q.put(None)
        for t in threads:
            t.join(timeout=timeout)


_gather_pool: Optional[_GatherPool] = None
_gather_pool_lock = threading.Lock()


def _gather_executor() -> _GatherPool:
    global _gather_pool
    with _gather_pool_lock:
        if _gather_pool is None:
            _gather_pool = _GatherPool(max_workers=4)
            atexit.register(_gather_pool.shutdown)
        return _gather_pool


def _off_reactor(fn: Callable[[], None]) -> None:
    """Run ``fn`` on the gather pool when called from a reactor completion
    pump, inline otherwise — detected by thread, not by submission phase, so
    the pump never memcpys even when a short emulated transfer retires
    mid-registration."""
    if in_reactor_thread():
        _gather_executor().submit(fn)
    else:
        _registry().counter("gather.inline").inc()
        fn()


class StripeChunk:
    """One stripe chunk of a logical zone extent, in logical order.

    ``index`` is the global chunk index (logical order key), ``device`` the
    member the chunk is READ from under the current member health (for
    ``raid1`` the round-robin replica, redirected to the survivor when its
    partner is OFFLINE; for a reconstructing ``xor`` chunk the row's parity
    member, the anchor of the survivor fan-in), ``local_off``/``n_blocks``
    the member-local extent. ``degraded`` marks a chunk served without its
    preferred member; ``reconstruct`` marks an xor chunk whose bytes must be
    rebuilt from the surviving row members rather than read directly.
    """

    __slots__ = ("index", "device", "local_off", "n_blocks", "logical_off",
                 "row", "col", "degraded", "reconstruct")

    def __init__(self, index: int, device: int, local_off: int,
                 n_blocks: int, logical_off: int, *, row: int = 0,
                 col: int = 0, degraded: bool = False,
                 reconstruct: bool = False):
        self.index = index
        self.device = device
        self.local_off = local_off
        self.n_blocks = n_blocks
        self.logical_off = logical_off
        self.row = row
        self.col = col
        self.degraded = degraded
        self.reconstruct = reconstruct

    def __repr__(self) -> str:
        flags = "".join(
            [" degraded" if self.degraded else "",
             " reconstruct" if self.reconstruct else ""])
        return (f"StripeChunk(#{self.index} dev{self.device} "
                f"local[{self.local_off},+{self.n_blocks}){flags})")


def coalesce_member_runs(
        chunks: Sequence[StripeChunk],
        stripe_blocks: int) -> list[tuple[int, list[tuple[int, StripeChunk]]]]:
    """Group ``chunks`` by member and split each member's share into maximal
    member-locally CONTIGUOUS runs — ``[(device, [(position, chunk), ...])]``
    where ``position`` is the chunk's index within the input sequence.

    One run is one device read: raid0/xor full chunks of a member are
    consecutive multiples of ``stripe_blocks`` apart so whole groups coalesce
    into a single transfer, while raid1's round-robin replica assignment
    leaves row-sized holes in member-local space and degrades to per-chunk
    runs. Layout-agnostic on purpose — the scheduler's staged read phase uses
    it for every redundancy mode, so a future placement scheme cannot
    silently break the fan-out's coalescing.
    """
    by_dev: dict[int, list[tuple[int, StripeChunk]]] = {}
    for pos, c in enumerate(chunks):
        by_dev.setdefault(c.device, []).append((pos, c))
    runs: list[tuple[int, list[tuple[int, StripeChunk]]]] = []
    for dev in sorted(by_dev):
        items = sorted(by_dev[dev], key=lambda pc: pc[1].local_off)
        run = [items[0]]
        for pc in items[1:]:
            prev = run[-1][1]
            if pc[1].local_off == prev.local_off + prev.n_blocks:
                run.append(pc)
            else:
                runs.append((dev, run))
                run = [pc]
        runs.append((dev, run))
    return runs


class _DirectRead:
    """One coalesced member-extent read, scattered into the logical buffer
    at completion time (possibly covering several logical chunks)."""

    __slots__ = ("device", "local_off", "n_blocks", "copies", "fut")

    def __init__(self, device: int, local_off: int, n_blocks: int,
                 copies: list[tuple[int, int, int]]):
        self.device = device
        self.local_off = local_off
        self.n_blocks = n_blocks
        self.copies = copies          # (src_block, dst_block, n_blocks)
        self.fut: Optional[IoFuture] = None

    def submit(self, arr: "StripedZoneArray", zone_id: int) -> tuple:
        self.fut = arr.devices[self.device].submit_read(
            zone_id, self.local_off, self.n_blocks)
        return (self.fut,)

    def attach(self, arr: "StripedZoneArray", out: np.ndarray,
               barrier: CompletionBarrier, slot: int) -> None:
        fut = self.fut

        def apply() -> None:
            err = fut.error
            if err is None:
                try:
                    buf = np.asarray(fut._value).reshape(-1, arr.block_bytes)
                    for src, dst, n in self.copies:
                        out[dst:dst + n] = buf[src:src + n]
                except BaseException as e:
                    err = e
            barrier.settle(slot, err)

        fut.add_done_callback(lambda _f: _off_reactor(apply))


class _XorReconstruct:
    """Rebuild a dead member's chunk span as the XOR of the surviving row
    members. ``seed`` starts as zeros (complete row: the parity chunk is one
    of the reads) or as the host parity-accumulator slice (tail row: the
    parity chunk has not landed yet, the accumulator IS its current value).
    Survivor reads are ordinary member transfers on the completion ring; the
    XOR combine runs once the last of them retires."""

    __slots__ = ("reads", "seed", "dst", "n_blocks", "futs")

    def __init__(self, reads: list[tuple[int, int, int]], seed: np.ndarray,
                 dst: int, n_blocks: int):
        self.reads = reads            # (device, local_off, n_avail > 0)
        self.seed = seed              # (n_blocks, block_bytes) uint8, owned
        self.dst = dst
        self.n_blocks = n_blocks
        self.futs: list[IoFuture] = []

    def submit(self, arr: "StripedZoneArray", zone_id: int) -> tuple:
        self.futs = [arr.devices[d].submit_read(zone_id, lo, n)
                     for d, lo, n in self.reads]
        return tuple(self.futs)

    def attach(self, arr: "StripedZoneArray", out: np.ndarray,
               barrier: CompletionBarrier, slot: int) -> None:
        def on_all(vals: list, err: Optional[BaseException]) -> None:
            def apply() -> None:
                e = err
                if e is None:
                    try:
                        acc = self.seed
                        for v in vals:
                            buf = np.asarray(v).reshape(-1, arr.block_bytes)
                            acc[: len(buf)] ^= buf
                        out[self.dst: self.dst + self.n_blocks] = acc
                    except BaseException as ee:
                        e = ee
                barrier.settle(slot, e)

            _off_reactor(apply)

        inner = CompletionBarrier(len(self.futs), on_all)
        for i, f in enumerate(self.futs):
            f.add_done_callback(lambda f, i=i: inner.settle(
                i, f.error, None if f.error is not None else f._value))


class LogicalZone:
    """View of one logical (striped) zone.

    Duck-types the fields of :class:`repro_torch.zns.device.Zone` that callers use:
    ``zone_id``, ``write_pointer`` (settable — distributes to members, needed
    by checkpoint recovery), ``state`` (derived; settable — broadcast to
    surviving members), ``capacity_blocks``, ``remaining_blocks``,
    ``is_writable``, ``reset_count``, plus ``degraded`` (a member zone is
    OFFLINE but the redundancy mode still covers its data).
    """

    def __init__(self, array: "StripedZoneArray", zone_id: int):
        self._array = array
        self.zone_id = zone_id

    def _members(self):
        return [d.zone(self.zone_id) for d in self._array.devices]

    @property
    def capacity_blocks(self) -> int:
        return self._array.zone_blocks

    @property
    def write_pointer(self) -> int:
        return self._array._wp[self.zone_id]

    @write_pointer.setter
    def write_pointer(self, w: int) -> None:
        self._array._set_write_pointer(self.zone_id, int(w))

    @property
    def state(self) -> ZoneState:
        arr = self._array
        with arr._lock:
            states = [z.state for z in self._members()]
            reb = arr._rebuilding.get(self.zone_id)
            off = [i for i, s in enumerate(states)
                   if s is ZoneState.OFFLINE or i == reb]
            if arr._is_unrecoverable(off):
                return ZoneState.OFFLINE
            if off or self.zone_id in arr._fenced:
                # degraded (redundancy covers the dead member) or torn (a
                # mid-append member failure): committed data stays readable,
                # new appends are refused until reset/rebuild
                return ZoneState.READ_ONLY
            alive = set(states)
            if ZoneState.READ_ONLY in alive:
                return ZoneState.READ_ONLY
            if alive == {ZoneState.EMPTY}:
                return ZoneState.EMPTY
            if alive == {ZoneState.FULL}:
                return ZoneState.FULL
            return ZoneState.OPEN

    @state.setter
    def state(self, st: ZoneState) -> None:
        with self._array._lock:
            reb = self._array._rebuilding.get(self.zone_id)
            for i, z in enumerate(self._members()):
                if z.state is ZoneState.OFFLINE or i == reb:
                    # fault injection is not undone by a broadcast, and a
                    # mid-rebuild member reconciles its state at cutover
                    continue
                z.state = st

    @property
    def degraded(self) -> bool:
        arr = self._array
        with arr._lock:
            off = arr._offline_members(self.zone_id)
            return bool(off) and not arr._is_unrecoverable(off)

    @property
    def reset_count(self) -> int:
        return max(z.reset_count for z in self._members())

    @property
    def remaining_blocks(self) -> int:
        return self.capacity_blocks - self.write_pointer

    @property
    def is_writable(self) -> bool:
        return self.state in (ZoneState.EMPTY, ZoneState.OPEN)

    def __repr__(self) -> str:
        return (f"LogicalZone(id={self.zone_id}, wp={self.write_pointer}/"
                f"{self.capacity_blocks}, state={self.state.value})")


class StripedZoneArray:
    """N identical ZNS devices presented as one logical zoned device, with
    optional redundancy (``raid0`` striping, ``raid1`` mirror pairs, ``xor``
    rotating parity)."""

    def __init__(self, devices: Sequence[ZonedDevice], *,
                 stripe_blocks: int = 16, redundancy: str = "raid0"):
        if not devices:
            raise ValueError("StripedZoneArray needs at least one device")
        d0 = devices[0]
        for i, d in enumerate(devices):
            if (d.num_zones, d.zone_blocks, d.block_bytes) != (
                    d0.num_zones, d0.zone_blocks, d0.block_bytes):
                raise ValueError(
                    f"member {i} geometry {(d.num_zones, d.zone_blocks, d.block_bytes)} "
                    f"differs from member 0 {(d0.num_zones, d0.zone_blocks, d0.block_bytes)}"
                )
        if stripe_blocks <= 0:
            raise ValueError("stripe_blocks must be positive")
        if d0.zone_blocks % stripe_blocks != 0:
            raise ValueError(
                f"stripe_blocks {stripe_blocks} must divide member zone size "
                f"{d0.zone_blocks} (chunks may not straddle member zones)"
            )
        if redundancy not in REDUNDANCY_MODES:
            raise ValueError(
                f"redundancy {redundancy!r} not one of {REDUNDANCY_MODES}")
        self.devices = list(devices)
        self.n_devices = len(self.devices)
        self.stripe_blocks = int(stripe_blocks)
        self.redundancy = redundancy
        if redundancy == "raid1":
            if self.n_devices < 2 or self.n_devices % 2:
                raise ValueError(
                    f"raid1 needs an even member count >= 2, got {self.n_devices}")
            self.data_columns = self.n_devices // 2
        elif redundancy == "xor":
            if self.n_devices < 3:
                raise ValueError(
                    f"xor needs >= 3 members (use raid1 for 2), got {self.n_devices}")
            self.data_columns = self.n_devices - 1
        else:
            self.data_columns = self.n_devices
        self.num_zones = d0.num_zones
        self.block_bytes = d0.block_bytes
        # logical geometry: every DATA column contributes its whole zone
        # (raid1 pairs store one copy per partner; xor spends one member's
        # worth of capacity on parity)
        self.zone_blocks = d0.zone_blocks * self.data_columns
        self.zone_bytes = self.zone_blocks * self.block_bytes
        self._lock = threading.RLock()
        # logical write pointers are array state (the one source of truth):
        # member write pointers derive from them per mode — xor parity
        # rotation makes a member-sum derivation ambiguous. Appends advance
        # _wp LAST, under the lock, once every member submission landed.
        self._wp = [0] * self.num_zones
        # zones torn by a mid-append member failure: some members landed
        # their share, others did not — committed data (< _wp) stays
        # readable, appends are fenced until reset_zone
        self._fenced: set[int] = set()
        # xor: host-side parity accumulator per zone — XOR of all data
        # landed in the (at most one) incomplete tail stripe row, i.e. the
        # value the row's parity chunk will have once the row completes
        # (a real RAID controller's NVRAM parity buffer)
        self._pacc: dict[int, np.ndarray] = {}
        # zones whose tail-row accumulator could NOT be recomputed at
        # write-pointer recovery (a tail-row data member was OFFLINE and its
        # parity never landed): tail reconstruction for these must raise,
        # never fabricate zero bytes
        self._pacc_lost: set[int] = set()
        # array-level counters on a PRIVATE registry (arrays are unbounded;
        # the process-global registry is reserved for singletons) — atomic,
        # so the fan-out finalize path no longer re-takes the array lock
        self.metrics = MetricsRegistry("array")
        self._c_degraded_reads = self.metrics.counter("degraded_reads")
        self._c_gather_bytes = self.metrics.counter("gather_bytes_copied")
        # zones that already announced degraded serving in the event log —
        # the first degraded read per zone is the operator-visible moment,
        # the per-read volume lives in the degraded_reads counter
        self._degraded_announced: set[int] = set()
        # zones mid-rebuild: {zone_id: member index being reconstructed}.
        # Planning treats the member as dead for these zones regardless of
        # its actual zone state (the spare's zone is revived EMPTY while the
        # copy runs), and the logical zone stays READ_ONLY — the write
        # pointer must not move under an in-progress reconstruction. Each
        # zone leaves the map individually at commit_member_rebuild, so
        # rebuilt zones accept appends while later zones are still copying.
        self._rebuilding: dict[int, int] = {}
        # member transfers fan out as in-flight completion-ring descriptors
        # (repro_torch.zns.ring): an N-member read holds N reactor slots and ZERO
        # worker threads, and CONCURRENT logical reads (different zones /
        # tenants) overlap on the members' per-zone virtual clocks instead of
        # queuing behind a thread-pool's size.
        self.zones = [LogicalZone(self, z) for z in range(self.num_zones)]

    # -------------------------------------------------------- address math
    def _row_devices(self, row: int) -> tuple[list[int], int]:
        """xor: (data devices in column order, parity device) for a stripe
        row — left-symmetric rotation, so parity load spreads evenly."""
        p = (self.n_devices - 1) - (row % self.n_devices)
        return [d for d in range(self.n_devices) if d != p], p

    def _replicas(self, row: int, col: int) -> tuple[int, ...]:
        """Members holding chunk (row, col)'s data, preferred-read first
        (raid1 round-robins the mirror pair by row for ~2x read bandwidth)."""
        if self.redundancy == "raid1":
            pref = 2 * col + (row & 1)
            return (pref, 2 * col + ((row & 1) ^ 1))
        if self.redundancy == "xor":
            return (self._row_devices(row)[0][col],)
        return (col,)

    def _offline_members(self, zone_id: int) -> list[int]:
        """Members the zone cannot be served from: actually-OFFLINE zones
        plus the member a rebuild is reconstructing (its revived spare zone
        holds no data yet)."""
        reb = self._rebuilding.get(zone_id)
        return [i for i, d in enumerate(self.devices)
                if i == reb or d.zone(zone_id).state is ZoneState.OFFLINE]

    def _is_unrecoverable(self, offline: list[int]) -> bool:
        """True when the OFFLINE member set defeats the redundancy mode."""
        if not offline:
            return False
        if self.redundancy == "raid0":
            return True
        if self.redundancy == "raid1":
            s = set(offline)
            return any(2 * c in s and 2 * c + 1 in s
                       for c in range(self.data_columns))
        return len(offline) > 1

    def _chunk_source(self, zone_id: int, row: int, col: int,
                      alive: list[bool]) -> tuple[int, bool, bool]:
        """(read device, degraded, reconstruct) for chunk (row, col) under
        the current member health."""
        if self.redundancy == "raid0":
            # dead members surface at member-read time (the PR 2 clean-error
            # contract); the logical zone is OFFLINE anyway
            return col, False, False
        if self.redundancy == "raid1":
            pref, alt = self._replicas(row, col)
            if alive[pref]:
                return pref, False, False
            if alive[alt]:
                return alt, True, False
            raise ZoneStateError(
                f"zone {zone_id} unrecoverable: both mirrors of column {col} "
                f"(devices {2 * col},{2 * col + 1}) are offline")
        data_devs, parity = self._row_devices(row)
        d = data_devs[col]
        if alive[d]:
            return d, False, False
        if sum(1 for a in alive if not a) > 1:
            raise ZoneStateError(
                f"zone {zone_id} unrecoverable: more than one member offline "
                f"under xor parity")
        return parity, True, True

    def chunks(self, zone_id: int, block_off: int, n_blocks: int) -> list[StripeChunk]:
        """Decompose a logical extent into stripe chunks, in logical order,
        with health-aware read-source assignment.

        Each chunk is contiguous both logically and on its member device —
        the unit the offload scheduler fans out. Chunks whose preferred
        member zone is OFFLINE come back ``degraded`` (raid1: redirected to
        the mirror partner) or ``degraded + reconstruct`` (xor: must be
        rebuilt from the surviving row members).
        """
        with self._lock:
            return self._plan_chunks(zone_id, block_off, n_blocks)

    def _plan_chunks(self, zone_id: int, block_off: int,
                     n_blocks: int) -> list[StripeChunk]:
        self.zone(zone_id)  # bounds-check the zone id
        s, C = self.stripe_blocks, self.data_columns
        reb = self._rebuilding.get(zone_id)
        alive = [i != reb and d.zone(zone_id).state is not ZoneState.OFFLINE
                 for i, d in enumerate(self.devices)]
        out: list[StripeChunk] = []
        b, end = block_off, block_off + n_blocks
        while b < end:
            chunk = b // s
            take = min(end - b, (chunk + 1) * s - b)
            row, col = divmod(chunk, C)
            local = row * s + b % s
            device, degraded, recon = self._chunk_source(
                zone_id, row, col, alive)
            out.append(StripeChunk(chunk, device, local, take, b, row=row,
                                   col=col, degraded=degraded,
                                   reconstruct=recon))
            b += take
        return out

    # ------------------------------------------------------------- zones
    def zone(self, zone_id: int) -> LogicalZone:
        if not 0 <= zone_id < self.num_zones:
            raise OutOfBoundsError(f"zone {zone_id} out of range [0,{self.num_zones})")
        return self.zones[zone_id]

    def report_zones(self) -> list[LogicalZone]:
        return list(self.zones)

    def open_zones(self) -> list[LogicalZone]:
        return [z for z in self.zones if z.state == ZoneState.OPEN]

    def _pacc_for(self, zone_id: int) -> np.ndarray:
        acc = self._pacc.get(zone_id)
        if acc is None:
            acc = self._pacc[zone_id] = np.zeros(
                (self.stripe_blocks, self.block_bytes), np.uint8)
        return acc

    # ------------------------------------------------------------- append
    def zone_append(self, zone_id: int, data: np.ndarray | bytes, *,
                    timeout: Optional[float] = None) -> int:
        """Striped Zone Append: split ``data`` into stripe chunks and append
        each member's share at that member's write pointer (mirrored on both
        partners under raid1; with a parity chunk per completed stripe row
        under xor). Returns the logical start block. Synchronous shim over
        :meth:`submit_append` — member transfers share one wall-clock window
        (each member's emulated busy time runs on its own zone clock), the
        call returns at the last member's completion deadline. ``timeout``
        bounds the wait; on expiry the ``TimeoutError`` names the stuck
        member transfer (a hung command cannot strand the caller)."""
        return self.submit_append(zone_id, data).result(timeout)

    def _append_plan(
        self, zone_id: int, start: int, blocks: np.ndarray
    ) -> list[tuple[int, np.ndarray, int]]:
        """Member appends for logical blocks [start, start+len(blocks)) as
        ``(device, payload, expected_landing_block)`` in submission order.
        Under xor this also folds the data into the zone's parity accumulator
        and emits the parity-chunk append of every row the payload completes.
        Caller holds the array lock."""
        s, C = self.stripe_blocks, self.data_columns
        n = len(blocks)
        plan: list[tuple[int, np.ndarray, int]] = []
        if self.redundancy != "xor":
            owner_col = (np.arange(start, start + n) // s) % C
            for c in range(C):
                sel = owner_col == c
                if not sel.any():
                    continue
                share = blocks[sel]
                first = start + int(np.flatnonzero(sel)[0])
                chunk, within = divmod(first, s)
                expect = (chunk // C) * s + within
                devs = (c,) if self.redundancy == "raid0" \
                    else (2 * c, 2 * c + 1)
                for dev in devs:
                    plan.append((dev, share, expect))
            return plan
        # A member's data chunks across consecutive rows are member-locally
        # contiguous except where the parity rotation makes it the parity
        # member, so buffer each member's share and flush one coalesced
        # append per contiguous run — ~(N-1) rows per member append instead
        # of one append per chunk. A member's parity chunk flushes its
        # buffered data first (its data for earlier rows must land below the
        # parity slot).
        acc = self._pacc_for(zone_id)
        pending: dict[int, list] = {}   # dev -> [parts, expect_local, nblocks]

        def flush(dev: int) -> None:
            entry = pending.pop(dev, None)
            if entry is None:
                return
            parts, expect, _nb = entry
            payload = parts[0] if len(parts) == 1 else np.concatenate(parts)
            plan.append((dev, payload, expect))

        b, end = start, start + n
        while b < end:
            chunk = b // s
            take = min(end - b, (chunk + 1) * s - b)
            row, col = divmod(chunk, C)
            within = b % s
            data_devs, parity = self._row_devices(row)
            d = data_devs[col]
            share = blocks[b - start: b - start + take]
            local = row * s + within
            entry = pending.get(d)
            if entry is not None and entry[1] + entry[2] == local:
                entry[0].append(share)
                entry[2] += take
            else:
                flush(d)
                pending[d] = [[share], local, take]
            acc[within: within + take] ^= share
            if col == C - 1 and b + take == (chunk + 1) * s:
                # the stripe row is complete: its parity value is final —
                # append it to the rotating parity member and reset the
                # accumulator for the next row
                flush(parity)
                plan.append((parity, acc.copy(), row * s))
                acc[:] = 0
            b += take
        for dev in list(pending):
            flush(dev)
        return plan

    def _refusal_detail(self, zone_id: int, state: ZoneState) -> str:
        """Append-refusal message naming WHY the logical zone is not
        writable — offline member indices, redundancy mode, rebuild/fence
        status — so operators can correlate the refusal with
        ``array.member_offline`` events instead of guessing. Caller holds
        the array lock."""
        clauses = [f"state={state}", f"redundancy={self.redundancy}"]
        offline = [i for i, d in enumerate(self.devices)
                   if d.zone(zone_id).state is ZoneState.OFFLINE]
        if offline:
            clauses.append(f"offline members={offline}")
        reb = self._rebuilding.get(zone_id)
        if reb is not None:
            clauses.append(f"member {reb} rebuilding onto spare")
        if zone_id in self._fenced:
            clauses.append("fenced by a torn/failed append")
        hint = ""
        if offline or reb is not None:
            hint = (" — correlate with array.member_offline events; appends "
                    "resume after rebuild-to-spare (or reset_zone)")
        return (f"logical zone {zone_id} not writable "
                f"({', '.join(clauses)}){hint}")

    def submit_append(self, zone_id: int, data: np.ndarray | bytes, *,
                      ring: Optional[CompletionRing] = None) -> IoFuture:
        """Asynchronous striped Zone Append: member writes land immediately
        (metadata and bytes, under the array lock), the returned future
        retires when the LAST member completion does, with the logical start
        block as its value. ``fut.submitted_block`` carries the logical start
        synchronously.

        A member failing mid-fan-out (e.g. its zone going OFFLINE between
        the array check and its submission) FAILS the aggregate instead of
        orphaning the already-submitted member futures: they settle a
        barrier that retires the aggregate with the error once the last of
        them completes, and the zone is fenced READ_ONLY (its members no
        longer agree on the stripe stream) until ``reset_zone``.
        """
        raw = payload_as_uint8(data)
        nblocks = -(-raw.size // self.block_bytes)  # ceil
        member_futs: list[IoFuture] = []
        error: Optional[BaseException] = None
        with self._lock:
            z = self.zone(zone_id)
            if not z.is_writable:
                raise ZoneStateError(self._refusal_detail(zone_id, z.state))
            start = z.write_pointer
            if nblocks > z.remaining_blocks:
                raise ZoneFullError(
                    f"append of {nblocks} blocks exceeds logical zone {zone_id} "
                    f"remaining {z.remaining_blocks}"
                )
            padded = np.zeros(nblocks * self.block_bytes, np.uint8)
            padded[: raw.size] = raw
            blocks = padded.reshape(nblocks, self.block_bytes)
            acc_backup = self._pacc_for(zone_id).copy() \
                if self.redundancy == "xor" else None
            try:
                plan = self._append_plan(zone_id, start, blocks)
                for dev_idx, payload, expect in plan:
                    f = self.devices[dev_idx].submit_append(zone_id, payload)
                    member_futs.append(f)
                    # member-local target is contiguous and starts at the
                    # member write pointer (appends only go through the array)
                    if f.submitted_block != expect:
                        raise ZoneStateError(
                            f"stripe desync on device {dev_idx} zone {zone_id}: "
                            f"member append landed at {f.submitted_block}, "
                            f"expected {expect}"
                        )
            except BaseException as e:
                error = e
                if acc_backup is not None:
                    self._pacc[zone_id] = acc_backup
                if member_futs:
                    self._fenced.add(zone_id)
            else:
                # the logical write pointer advances LAST, under this lock:
                # readers never see a range whose member shares have not all
                # been submitted
                self._wp[zone_id] = start + nblocks

        agg = IoFuture(op="append", zone_id=zone_id, block_off=start,
                       nblocks=nblocks,
                       service_seconds=max(
                           (f.service_seconds for f in member_futs),
                           default=0.0),
                       ring=ring)
        agg.submitted_block = start
        agg.device = "array"
        agg.waits_on = member_futs
        if error is not None:
            if member_futs:
                # the zone was fenced above: members no longer agree on the
                # stripe stream until reset_zone
                _publish_event(
                    "array.zone_fenced", severity=_Sev.ERROR,
                    message=f"logical zone {zone_id} fenced READ_ONLY after "
                            f"torn append: {error}",
                    zone=zone_id, error=type(error).__name__)
            err = error
            barrier = CompletionBarrier(
                len(member_futs), lambda _vals, _e: agg.fail(err))
            for i, f in enumerate(member_futs):
                f.add_done_callback(lambda f, i=i: barrier.settle(i, f.error))
            return agg
        self._join_members(
            agg, member_futs, lambda: start,
            on_error=lambda err: self._fence_on_completion(zone_id, err))
        return agg

    @staticmethod
    def _join_members(agg: IoFuture, member_futs: list[IoFuture],
                      finalize: Callable[[], object],
                      on_error: Optional[Callable[[BaseException], None]] = None
                      ) -> None:
        """Retire ``agg`` with ``finalize()`` (or the first member error) once
        every member future has retired. Members that completed inline fire
        their callback inline, so a fully-inline fan-out retires ``agg``
        before this returns (including the zero-member case). ``on_error``
        runs before the aggregate fails — the append path fences the zone
        there, since a member completion error (exhausted retry budget, torn
        append) means the members no longer agree on the stripe stream."""

        def done(_vals, err):
            if err is not None:
                if on_error is not None:
                    on_error(err)
                agg.fail(err)
            else:
                agg.complete(finalize())

        barrier = CompletionBarrier(len(member_futs), done)
        for i, f in enumerate(member_futs):
            f.add_done_callback(lambda f, i=i: barrier.settle(i, f.error))

    def _fence_on_completion(self, zone_id: int, err: BaseException) -> None:
        """A member append FAILED at completion time (the submit itself was
        legal): fence the logical zone READ_ONLY — its members may disagree
        on the stripe stream past the last joined append — and page the
        operator. Reads still serve; appends refuse until ``reset_zone``.
        Idempotent per fence epoch."""
        with self._lock:
            if zone_id in self._fenced:
                return
            self._fenced.add(zone_id)
        _publish_event(
            "array.zone_fenced", severity=_Sev.ERROR,
            message=f"logical zone {zone_id} fenced READ_ONLY after a member "
                    f"append failed at completion: {err}",
            zone=zone_id, error=type(err).__name__)

    # --------------------------------------------------------------- read
    def read_blocks(self, zone_id: int, block_off: int, nblocks: int, *,
                    timeout: Optional[float] = None) -> np.ndarray:
        """Striped read, interleaved back into logical order (reconstructing
        any chunk whose member is OFFLINE under raid1/xor).

        Only the bounds check, address math, and member submissions run
        under the array lock; member transfers (and their emulated bandwidth
        time) ride the completion ring, so concurrent array-level reads —
        different zones, different tenants — overlap instead of queuing
        behind one logical read or a worker-pool's thread count. Safe
        against concurrent appends because the logical write pointer only
        covers member blocks whose appends have fully landed (appends update
        it last, under this lock). Resetting + rewriting a zone while a read
        of it is in flight is a host protocol bug (same contract as
        ``ZonedDevice.read_blocks_view``, and as real ZNS hardware).
        ``timeout`` bounds the join; on expiry the ``TimeoutError`` names
        the member transfer still in flight.
        """
        out = self.submit_read(zone_id, block_off, nblocks).result(timeout)
        out = np.asarray(out)
        out = out.view()               # the gather buffer is private: hand the
        out.flags.writeable = True     # sync caller an owned, mutable stream
        return out

    def _read_jobs(self, zone_id: int, block_off: int,
                   chunks: list[StripeChunk]) -> list:
        """Scatter units for a striped read: direct member reads (coalesced
        while member-locally contiguous — raid0's one-read-per-device fast
        path falls out of this) plus one XOR-reconstruction job per dead-
        member chunk. Caller holds the array lock."""
        jobs: list = []
        open_direct: dict[int, _DirectRead] = {}
        for c in chunks:
            dst = c.logical_off - block_off
            if c.reconstruct:
                jobs.append(self._xor_job(zone_id, c, dst))
                continue
            run = open_direct.get(c.device)
            if run is not None and run.local_off + run.n_blocks == c.local_off:
                run.copies.append((run.n_blocks, dst, c.n_blocks))
                run.n_blocks += c.n_blocks
            else:
                run = _DirectRead(c.device, c.local_off, c.n_blocks,
                                  [(0, dst, c.n_blocks)])
                open_direct[c.device] = run
                jobs.append(run)
        return jobs

    def _xor_job(self, zone_id: int, c: StripeChunk, dst: int) -> _XorReconstruct:
        """Survivor reads + seed buffer reconstructing chunk ``c`` (xor mode,
        its data member OFFLINE). Complete rows XOR the parity chunk with the
        other data chunks; the tail row seeds from the host parity
        accumulator (its parity chunk has not landed) and XORs out the
        survivors' present spans. Caller holds the array lock."""
        s, C = self.stripe_blocks, self.data_columns
        a = c.local_off - c.row * s          # offset within the stripe row
        data_devs, parity = self._row_devices(c.row)
        reads: list[tuple[int, int, int]] = []
        if self._wp[zone_id] >= (c.row + 1) * C * s:   # row complete
            seed = np.zeros((c.n_blocks, self.block_bytes), np.uint8)
            for c2, d in enumerate(data_devs):
                if c2 != c.col:
                    reads.append((d, c.local_off, c.n_blocks))
            reads.append((parity, c.local_off, c.n_blocks))
        else:
            if zone_id in self._pacc_lost:
                raise ZoneStateError(
                    f"zone {zone_id} tail-row chunk {c.index} is "
                    f"unrecoverable: its parity never landed and the "
                    f"accumulator was recovered with a member already "
                    f"offline (tail data lost)")
            rem = self._wp[zone_id] - c.row * C * s
            rc, partial = divmod(rem, s)
            seed = self._pacc_for(zone_id)[a: a + c.n_blocks].copy()
            for c2, d in enumerate(data_devs):
                if c2 == c.col:
                    continue
                avail = s if c2 < rc else (partial if c2 == rc else 0)
                n2 = min(c.n_blocks, max(0, avail - a))
                if n2 > 0:
                    reads.append((d, c.local_off, n2))
        return _XorReconstruct(reads, seed, dst, c.n_blocks)

    def submit_read(self, zone_id: int, block_off: int, nblocks: int, *,
                    dtype: Optional[np.dtype | str] = None,
                    ring: Optional[CompletionRing] = None) -> IoFuture:
        """Asynchronous striped read: in-flight member transfers gathered
        into logical stripe order as their completions retire; the returned
        future retires with the last member's, valued as the read-only
        interleaved extent (``dtype``-typed when given). Chunks owned by an
        OFFLINE member are served degraded — raid1 redirects to the mirror
        partner, xor XORs the surviving row members — on the SAME completion
        ring (no extra threads; reconstruction is completion-time work on
        the gather pool).

        A member failing mid-fan-out fails the aggregate through the job
        barrier: already-submitted member completions settle their slots as
        they retire, the unsubmitted remainder settles with the error, so
        the aggregate ALWAYS retires (no orphaned futures, no hanging
        callers).
        """
        if dtype is not None:
            dtype = block_aligned_dtype(self.block_bytes, dtype)
        with self._lock:
            z = self.zone(zone_id)
            if z.state is ZoneState.OFFLINE:
                raise ZoneStateError(f"logical zone {zone_id} is offline")
            if block_off < 0 or nblocks < 0 or block_off + nblocks > z.write_pointer:
                raise OutOfBoundsError(
                    f"read [{block_off},{block_off + nblocks}) beyond write pointer "
                    f"{z.write_pointer} of logical zone {zone_id}"
                )
            agg = IoFuture(op="read", zone_id=zone_id, block_off=block_off,
                           nblocks=nblocks, ring=ring)
            agg.device = "array"
            out = np.empty((nblocks, self.block_bytes), np.uint8)

            def finalize():
                self._c_gather_bytes.inc(out.nbytes)
                flat = out.reshape(-1)
                if dtype is not None:
                    flat = flat.view(dtype)
                flat.flags.writeable = False
                return flat

            if nblocks == 0:
                agg.complete(finalize())
                return agg
            chunks = self._plan_chunks(zone_id, block_off, nblocks)
            n_degraded = sum(1 for c in chunks if c.degraded)
            if n_degraded:
                self._c_degraded_reads.inc(n_degraded)
            jobs = self._read_jobs(zone_id, block_off, chunks)
            barrier = CompletionBarrier(
                len(jobs),
                lambda _vals, err: agg.fail(err) if err is not None
                else agg.complete(finalize()))
            submitted: list[tuple[int, object]] = []
            member_futs: list[IoFuture] = []
            service = 0.0
            for ji, job in enumerate(jobs):
                try:
                    futs = job.submit(self, zone_id)
                except BaseException as e:
                    for rest in range(ji, len(jobs)):
                        barrier.settle(rest, e)
                    break
                submitted.append((ji, job))
                for f in futs:
                    member_futs.append(f)
                    service = max(service, f.service_seconds)
            agg.service_seconds = service
            agg.waits_on = member_futs  # stuck-op diagnosis in result(timeout)
        # attach OUTSIDE the lock: inline completions (the non-emulated fast
        # path) then gather on the submitting thread without holding the
        # array lock; reactor-retired completions route through the gather
        # pool (detected by thread — the pump never memcpys)
        for ji, job in submitted:
            job.attach(self, out, barrier, ji)
        if n_degraded:
            self.note_degraded_serving(zone_id)
        return agg

    def note_degraded_serving(self, zone_id: int) -> None:
        """Publish the once-per-zone (until reset) operator event the first
        time a logical zone serves reads via reconstruction/redirect —
        per-read volume lives in the ``degraded_reads`` counter. Every read
        planner (the direct submit path and the offload scheduler's chunk
        planner) calls this outside the array lock; the lock is re-taken
        only for the announced-set check."""
        with self._lock:
            if zone_id in self._degraded_announced:
                return
            self._degraded_announced.add(zone_id)
        _publish_event(
            "array.degraded_read", severity=_Sev.WARNING,
            message=f"logical zone {zone_id} now serving degraded reads "
                    f"({self.redundancy})",
            zone=zone_id, redundancy=self.redundancy)

    def read_blocks_view(self, zone_id: int, block_off: int, nblocks: int) -> np.ndarray:
        """Minimal-copy read for the ``ZonedDevice`` view contract: a striped
        extent is not contiguous in any member buffer, so the stripe gather
        into logical order IS the single unavoidable copy."""
        out = self.read_blocks(zone_id, block_off, nblocks)
        out.flags.writeable = False
        return out

    def read_extent(self, zone_id: int, block_off: int, nblocks: int,
                    dtype: np.dtype | str) -> np.ndarray:
        """Dtype-typed minimal-copy read (one gather copy; the reinterpreting
        view is free — block alignment exceeds any element alignment)."""
        dtype = block_aligned_dtype(self.block_bytes, dtype)
        return self.read_blocks_view(zone_id, block_off, nblocks).view(dtype)

    def read_zone(self, zone_id: int) -> np.ndarray:
        return self.read_blocks(zone_id, 0, self.zone(zone_id).write_pointer)

    # ---------------------------------------------------- zone management
    def _member_write_pointers(self, w: int) -> list[int]:
        """Member write pointers implied by logical write pointer ``w``:
        member ``d`` owns exactly the blocks its mode maps there (under xor
        the parity chunks of FULL rows have landed, the tail row's has not).
        Pure address math — also the rebuild target a reconstructed member
        zone must reach before cutover."""
        s, C = self.stripe_blocks, self.data_columns
        full_rows, rem = divmod(int(w), s * C)
        rem_chunks, partial = divmod(rem, s)

        def tail(col: int) -> int:
            if col < rem_chunks:
                return s
            return partial if col == rem_chunks else 0

        if self.redundancy == "raid0":
            return [full_rows * s + tail(c) for c in range(C)]
        if self.redundancy == "raid1":
            return [full_rows * s + tail(d // 2)
                    for d in range(self.n_devices)]
        data_devs, _parity = self._row_devices(full_rows)
        wps = [full_rows * s] * self.n_devices
        for c in range(C):
            wps[data_devs[c]] += tail(c)
        return wps

    def _set_write_pointer(self, zone_id: int, w: int) -> None:
        """Distribute a logical write pointer across members (checkpoint
        recovery): member ``d`` owns the blocks its mode maps there. Under
        xor the parity members of full rows are assumed landed, and the
        tail-row parity accumulator is recomputed from the surviving
        members' data."""
        s, C = self.stripe_blocks, self.data_columns
        with self._lock:
            if zone_id in self._rebuilding:
                raise ZoneStateError(
                    f"logical zone {zone_id} write pointer frozen: member "
                    f"{self._rebuilding[zone_id]} rebuild in progress")
            full_rows, rem = divmod(int(w), s * C)
            rem_chunks, partial = divmod(rem, s)

            def tail(col: int) -> int:
                if col < rem_chunks:
                    return s
                return partial if col == rem_chunks else 0

            for d, wp in enumerate(self._member_write_pointers(w)):
                self.devices[d].zone(zone_id).write_pointer = wp
            self._wp[zone_id] = int(w)
            if self.redundancy == "xor":
                data_devs, _parity = self._row_devices(full_rows)
                acc = self._pacc_for(zone_id)
                acc[:] = 0
                self._pacc_lost.discard(zone_id)
                for c in range(C):
                    av = tail(c)
                    if not av:
                        continue
                    dev = self.devices[data_devs[c]]
                    if dev.zone(zone_id).state is ZoneState.OFFLINE:
                        # the dead member's tail-row data cannot re-enter the
                        # accumulator (its parity never landed): that span is
                        # GONE — mark it so tail reconstruction raises instead
                        # of silently returning zero bytes
                        self._pacc_lost.add(zone_id)
                        continue
                    acc[:av] ^= dev.read_blocks(
                        zone_id, full_rows * s, av).reshape(-1, self.block_bytes)

    def _zone_transition(self, zone_id: int, what: str,
                         fn: Callable[[ZonedDevice], None]) -> None:
        """Array-wide zone state transition under the array lock (a
        concurrent ``set_offline`` can no longer interleave mid-loop), with
        the OFFLINE guard ``reset_zone`` always had. A member failing
        mid-loop surfaces as :class:`ZoneStateError` naming the partial
        state instead of silently leaving members mixed."""
        with self._lock:
            if self.zone(zone_id).state is ZoneState.OFFLINE:
                raise ZoneStateError(f"logical zone {zone_id} is offline")
            reb = self._rebuilding.get(zone_id)
            done = 0
            try:
                for i, dev in enumerate(self.devices):
                    if dev.zone(zone_id).state is ZoneState.OFFLINE or i == reb:
                        # degraded survivors still transition; a mid-rebuild
                        # member reconciles its state at cutover
                        continue
                    fn(dev)
                    done += 1
            except ZNSError as e:
                raise ZoneStateError(
                    f"partial {what} of logical zone {zone_id}: {done}/"
                    f"{self.n_devices} members transitioned before a member "
                    f"refused: {e}"
                ) from e

    def finish_zone(self, zone_id: int) -> None:
        self._zone_transition(zone_id, "finish",
                              lambda dev: dev.finish_zone(zone_id))

    def set_read_only(self, zone_id: int) -> None:
        self._zone_transition(zone_id, "set_read_only",
                              lambda dev: dev.set_read_only(zone_id))

    def reset_zone(self, zone_id: int) -> None:
        with self._lock:
            if self.zone(zone_id).state is ZoneState.OFFLINE:
                raise ZoneStateError(f"logical zone {zone_id} is offline")
            offline = self._offline_members(zone_id)
            if offline:
                raise ZoneStateError(
                    f"logical zone {zone_id} degraded (members {offline} "
                    f"offline): rebuild before reset")
            for dev in self.devices:
                dev.reset_zone(zone_id)
            self._wp[zone_id] = 0
            self._fenced.discard(zone_id)
            self._degraded_announced.discard(zone_id)
            self._pacc_lost.discard(zone_id)
            if zone_id in self._pacc:
                self._pacc[zone_id][:] = 0

    def set_offline(self, zone_id: int, *, device: Optional[int] = None) -> None:
        """Fault injection: kill the zone on one member (``device``) or all.
        Taken under the array lock so state transitions and read planning
        see a consistent member-health snapshot."""
        with self._lock:
            targets = self.devices if device is None else [self.devices[device]]
            for dev in targets:
                dev.set_offline(zone_id)
        members = list(range(self.n_devices)) if device is None else [device]
        _publish_event(
            "array.member_offline", severity=_Sev.ERROR,
            message=f"zone {zone_id} killed on member(s) {members} "
                    f"({self.redundancy})",
            zone=zone_id, members=members, redundancy=self.redundancy)

    # ----------------------------------------------------- rebuild protocol
    # The low-level contract ArrayManager (repro_torch.array.rebuild) drives:
    #   replace_member       swap a dead member for a spare, mark its zones
    #   begin_member_rebuild revive ONE spare zone EMPTY, freeze the logical wp
    #   <manager copies member_shard() bytes via ordinary appends>
    #   commit_member_rebuild per-zone cutover under the array lock — the zone
    #                        leaves the _rebuilding map (and thus READ_ONLY)
    #                        while later zones are still copying
    # Everything here is metadata under the array lock; the bulk copy itself
    # is ordinary (meterable, failable) member I/O owned by the manager.

    def replace_member(self, member: int, new_device: ZonedDevice) -> list[int]:
        """Swap ``new_device`` (a hot spare) into seat ``member`` and return
        the zone ids whose data must be reconstructed onto it.

        Pending zones enter the ``_rebuilding`` map and the spare's zone is
        parked OFFLINE (quietly — placeholder marking, not a health event)
        until ``begin_member_rebuild`` revives it for the copy. Zones already
        unrecoverable (xor double fault, both raid1 partners dead) are parked
        offline on the spare and NOT returned — their data is gone, rebuild
        cannot invent it. Replacing a member whose data is still live is
        refused when another member is already offline and the swap would
        turn a recoverable zone unrecoverable."""
        if not 0 <= member < self.n_devices:
            raise ValueError(f"member {member} out of range [0,{self.n_devices})")
        d0 = self.devices[0]
        if (new_device.num_zones, new_device.zone_blocks,
                new_device.block_bytes) != (
                d0.num_zones, d0.zone_blocks, d0.block_bytes):
            raise ValueError(
                f"spare geometry {(new_device.num_zones, new_device.zone_blocks, new_device.block_bytes)} "
                f"differs from array {(d0.num_zones, d0.zone_blocks, d0.block_bytes)}")
        with self._lock:
            pending: list[int] = []
            lost: list[int] = []
            plans: list[tuple[int, bool]] = []   # (zone, recoverable)
            for z in range(self.num_zones):
                if self._wp[z] == 0:
                    continue            # nothing landed: spare zone serves as-is
                off_now = self._offline_members(z)
                off_after = sorted(set(i for i in off_now if i != member)
                                   | {member})
                if self._is_unrecoverable(off_after):
                    if not self._is_unrecoverable(off_now):
                        # the seat still holds the only copy of live data —
                        # pulling it is operator error, refuse atomically
                        raise ZoneStateError(
                            f"replacing member {member} would make zone {z} "
                            f"unrecoverable (members {off_now} already "
                            f"offline, redundancy={self.redundancy})")
                    plans.append((z, False))
                else:
                    plans.append((z, True))
            for z, recoverable in plans:
                new_device.set_offline(z, quiet=True)
                if recoverable:
                    self._rebuilding[z] = member
                    pending.append(z)
                else:
                    lost.append(z)
            self.devices[member] = new_device
        _publish_event(
            "array.member_replaced", severity=_Sev.WARNING,
            message=f"member {member} replaced by spare dev{new_device.dev_ordinal}: "
                    f"{len(pending)} zone(s) pending rebuild"
                    + (f", {len(lost)} unrecoverable" if lost else ""),
            member=member, spare=new_device.dev_ordinal,
            pending=len(pending), lost=lost, redundancy=self.redundancy)
        return pending

    def rebuilding_zones(self) -> dict[int, int]:
        """Zones mid-rebuild as ``{zone_id: member index}`` (snapshot)."""
        with self._lock:
            return dict(self._rebuilding)

    def begin_member_rebuild(self, zone_id: int) -> tuple[int, int]:
        """Open one marked zone for reconstruction: revive the spare's
        parked zone EMPTY and return ``(member, logical_wp)`` — the copy
        target. Idempotent/restartable: a partially-copied zone (spare died
        or the manager crashed mid-copy) is re-parked and revived, so the
        copy always restarts from block 0."""
        with self._lock:
            member = self._rebuilding.get(zone_id)
            if member is None:
                raise ZoneStateError(
                    f"zone {zone_id} is not marked for rebuild "
                    f"(replace_member first)")
            dev = self.devices[member]
            mz = dev.zone(zone_id)
            if mz.state is not ZoneState.OFFLINE and mz.write_pointer > 0:
                dev.set_offline(zone_id, quiet=True)   # discard partial copy
            if dev.zone(zone_id).state is ZoneState.OFFLINE:
                dev.revive_zone(zone_id)
            return member, self._wp[zone_id]

    def commit_member_rebuild(self, zone_id: int) -> int:
        """Per-zone cutover: verify the reconstructed member zone reached
        exactly the write pointer the logical geometry implies, reconcile
        its state with the survivors', and lift the zone out of the
        ``_rebuilding`` map — appends resume here while later zones are
        still copying. Returns the member index."""
        with self._lock:
            member = self._rebuilding.get(zone_id)
            if member is None:
                raise ZoneStateError(
                    f"zone {zone_id} has no rebuild in progress to commit")
            dev = self.devices[member]
            mz = dev.zone(zone_id)
            expect = self._member_write_pointers(self._wp[zone_id])[member]
            if mz.state is ZoneState.OFFLINE or mz.write_pointer != expect:
                raise ZoneStateError(
                    f"rebuild cutover of zone {zone_id} refused: member "
                    f"{member} at wp {mz.write_pointer} (state={mz.state}), "
                    f"expected wp {expect}")
            surv = {z.state for i, d in enumerate(self.devices)
                    if i != member
                    and (z := d.zone(zone_id)).state is not ZoneState.OFFLINE}
            if ZoneState.READ_ONLY in surv:
                dev.set_read_only(zone_id)
            elif surv == {ZoneState.FULL} and mz.state is not ZoneState.FULL:
                dev.finish_zone(zone_id)
            del self._rebuilding[zone_id]
            self._degraded_announced.discard(zone_id)
        _publish_event(
            "array.zone_rebuilt", severity=_Sev.INFO,
            message=f"zone {zone_id} rebuilt onto member {member}: "
                    f"writable again",
            zone=zone_id, member=member, redundancy=self.redundancy)
        return member

    def abandon_member_rebuild(self, zone_id: int) -> None:
        """Give up reconstructing one zone (double fault on the source
        side): the partial copy is parked OFFLINE — a half-written member
        must never serve reads — and the zone leaves the rebuild map, so
        its logical state reflects the true member health."""
        with self._lock:
            member = self._rebuilding.pop(zone_id, None)
            if member is None:
                return
            dev = self.devices[member]
            if dev.zone(zone_id).state is not ZoneState.OFFLINE:
                dev.set_offline(zone_id, quiet=True)

    def member_shard(self, member: int, logical: np.ndarray, *,
                     base_block: int = 0) -> np.ndarray:
        """The byte stream member ``member`` stores for the logical extent
        ``[base_block, base_block + len(logical))`` — the rebuild payload.

        ``logical`` is ``(n, block_bytes)`` uint8 in logical block order;
        ``base_block`` must be stripe-row aligned (a multiple of
        ``stripe_blocks * data_columns``), so batched rebuild reads stay
        row-aligned and the xor parity rotation lines up. raid0/raid1
        members store their column's chunks verbatim; an xor member stores
        its data chunks plus, on rows where the rotation makes it the
        parity member, the XOR of the row's data chunks. The (at most one)
        incomplete tail row contributes data chunks only — its parity
        chunk has not landed (the host accumulator stands in for it)."""
        s, C = self.stripe_blocks, self.data_columns
        bb = self.block_bytes
        if not 0 <= member < self.n_devices:
            raise ValueError(f"member {member} out of range [0,{self.n_devices})")
        if base_block % (s * C):
            raise ValueError(
                f"base_block {base_block} not stripe-row aligned "
                f"(row = {s * C} blocks)")
        logical = np.ascontiguousarray(logical).reshape(-1, bb)
        n = len(logical)
        full_rows, rem = divmod(n, s * C)
        rem_chunks, partial = divmod(rem, s)

        def tail(col: int) -> int:
            if col < rem_chunks:
                return s
            return partial if col == rem_chunks else 0

        parts: list[np.ndarray] = []
        if self.redundancy != "xor":
            col = member if self.redundancy == "raid0" else member // 2
            for r in range(full_rows):
                base = (r * C + col) * s
                parts.append(logical[base: base + s])
            t = tail(col)
            if t:
                base = full_rows * s * C + col * s
                parts.append(logical[base: base + t])
        else:
            row0 = base_block // (s * C)
            for r in range(full_rows):
                data_devs, parity = self._row_devices(row0 + r)
                base = r * s * C
                if member == parity:
                    chunk = logical[base: base + s].copy()
                    for c in range(1, C):
                        chunk ^= logical[base + c * s: base + (c + 1) * s]
                    parts.append(chunk)
                else:
                    c = data_devs.index(member)
                    parts.append(logical[base + c * s: base + (c + 1) * s])
            if rem:
                data_devs, parity = self._row_devices(row0 + full_rows)
                if member != parity:
                    c = data_devs.index(member)
                    t = tail(c)
                    if t:
                        base = full_rows * s * C + c * s
                        parts.append(logical[base: base + t])
        if not parts:
            return np.empty((0, bb), np.uint8)
        return np.concatenate(parts)

    def tail_parity(self, zone_id: int) -> Optional[np.ndarray]:
        """Snapshot of the host-side tail-row parity accumulator (xor mode):
        the value the incomplete row's parity chunk WILL have once the row
        completes — what a scrub checks the tail data against. ``None`` for
        non-xor arrays and for zones whose accumulator was lost at recovery
        (``_pacc_lost``)."""
        with self._lock:
            if self.redundancy != "xor" or zone_id in self._pacc_lost:
                return None
            return self._pacc_for(zone_id).copy()

    # --------------------------------------------------------------- misc
    def flush(self) -> None:
        for dev in self.devices:
            dev.flush()

    def close(self) -> None:
        """Kept for API compatibility: member I/O rides the shared completion
        ring now, so the array holds no worker threads to release."""

    def __enter__(self) -> "StripedZoneArray":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def lba_size(self) -> int:
        return self.block_bytes

    @property
    def stats(self) -> dict:
        """Aggregate member device statistics (NVMe log-page analogue), plus
        the array-level stripe gather copies and degraded-read count."""
        agg: dict[str, int] = {}
        for dev in self.devices:
            for k, v in dev.stats.items():
                agg[k] = agg.get(k, 0) + v
        agg["bytes_copied"] = agg.get("bytes_copied", 0) + self._c_gather_bytes.value
        agg["degraded_reads"] = agg.get("degraded_reads", 0) + self._c_degraded_reads.value
        return agg

    def utilization(self) -> float:
        written = sum(self._wp)
        return written / float(self.num_zones * self.zone_blocks)
