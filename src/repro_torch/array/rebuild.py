"""Self-healing array manager: rebuild-to-spare, scrub, spare promotion.

PR 5 made a degraded raid1/xor zone *survive* — reads reconstruct, appends
fence — and PR 7 made the decay *visible* (SMART-style health monitors, an
edge-triggered alert engine). This module closes the loop the ROADMAP's
"Self-managing array" item asks for: the array **recovers unattended**.

:class:`ArrayManager` owns a pool of hot-spare devices and runs two
background loops over a :class:`~repro_torch.array.striping.StripedZoneArray`:

  * **online rebuild** — after :meth:`promote_spare` swaps a spare into a
    dead member's seat (:meth:`StripedZoneArray.replace_member`), a worker
    reconstructs the member zone by zone: read the logical extent (raid1
    mirror copy / xor survivor reconstruction, riding the existing
    completion-ring degraded-read machinery), derive the member's shard
    (:meth:`StripedZoneArray.member_shard` — data chunks plus rotated
    parity under xor), and append it to the spare. When a scheduler is
    attached the copy traffic is raw I/O on a dedicated ``"rebuild"``
    tenant, so WRR arbitration meters it against live offload traffic.
    Cutover is **per zone** under the array lock
    (:meth:`StripedZoneArray.commit_member_rebuild`): rebuilt zones leave
    READ_ONLY and accept appends again while later zones are still copying.
  * **background scrub** — :meth:`scrub` reads every stripe row at low
    priority (the ``"scrub"`` tenant), verifies mirror equality (raid1) or
    parity consistency (xor, including the incomplete tail row against the
    host parity accumulator), publishes ``scrub.mismatch`` events and
    charges ``scrub_mismatches`` to the implicated devices' metric
    registries — which the :class:`DeviceHealthMonitor` counts as media
    errors, so silent corruption pages like any other fault.

**Automatic spare promotion** plugs into the seat PR 7 reserved:
:meth:`attach` registers an ``AlertEngine.on_alert`` callback that maps a
``member_degraded`` incident key (``member<i>/dev<ordinal>``) to
:meth:`promote_spare`. Promotion is idempotent per incident — an alert
re-fire or a concurrent manual promotion never double-promotes — and the
member's health monitor is rebound to the spare, so the incident resolves
(``alert.resolved``) on the next evaluation instead of paging forever.

Fault posture, by injection point:

  * member death **during** rebuild (the spare dies) — the rebuild restarts
    onto the next spare (``rebuild.restarted``), or degrades cleanly when
    the pool is empty (``rebuild.failed``; partial copies are parked
    OFFLINE, never served);
  * **double fault** on xor (a survivor dies mid-copy) — the zone's rebuild
    is abandoned (``rebuild.zone_failed``), the zone goes OFFLINE through
    the ordinary redundancy math; no corruption, no hang;
  * everything is restartable — :meth:`StripedZoneArray.begin_member_rebuild`
    re-parks partial copies, so a crashed manager resumes from block 0 of
    whatever zones remain marked.
"""
from __future__ import annotations

import re
import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.telemetry.events import Severity as _Sev, publish as _publish_event
from repro_torch.telemetry.health import ArrayHealthMonitor, DeviceHealthMonitor
from repro_torch.telemetry.metrics import registry as _registry
from repro_torch.zns.device import ZNSError, ZonedDevice
from repro_torch.array.striping import StripedZoneArray

__all__ = ["ArrayManager", "RebuildError"]


class RebuildError(Exception):
    """A rebuild could not complete (no spares left / unrecoverable source)."""


_MEMBER_KEY = re.compile(r"member(\d+)\b")


class ArrayManager:
    """Owns hot spares and the rebuild/scrub loops for one striped array.

    ``scheduler`` (an :class:`~repro_torch.array.scheduler.OffloadScheduler`) is
    optional: with one, rebuild/scrub I/O rides the per-tenant SQs and WRR
    arbitration (the production shape); without one, the manager issues
    direct array/device I/O (the unit-test shape). ``monitor`` (an
    :class:`ArrayHealthMonitor`) is rebound per seat on promotion so
    incidents resolve once the spare is in place.
    """

    def __init__(
        self,
        array: StripedZoneArray,
        *,
        scheduler=None,
        spares: Sequence[ZonedDevice] = (),
        monitor: Optional[ArrayHealthMonitor] = None,
        rebuild_tenant: str = "rebuild",
        scrub_tenant: str = "scrub",
        rebuild_weight: int = 1,
        scrub_weight: int = 1,
        rows_per_io: int = 8,
    ):
        self.array = array
        self.scheduler = scheduler
        self.monitor = monitor
        self.rebuild_tenant = rebuild_tenant
        self.scrub_tenant = scrub_tenant
        self.rows_per_io = int(rows_per_io)
        self._spares: list[ZonedDevice] = list(spares)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._threads: dict[int, threading.Thread] = {}
        self._member_status: dict[int, dict] = {}
        self._handled: set[str] = set()        # promotion incident keys seen
        self._scrub_thread: Optional[threading.Thread] = None
        self._unsubscribe = None
        if scheduler is not None:
            for tenant, weight in ((rebuild_tenant, rebuild_weight),
                                   (scrub_tenant, scrub_weight)):
                if tenant not in scheduler._pairs:
                    scheduler.register_tenant(tenant, weight=weight)
        reg = _registry()
        self._g_total = reg.gauge("rebuild.zones_total")
        self._g_done = reg.gauge("rebuild.zones_done")
        self._g_progress = reg.gauge("rebuild.progress")
        self._g_active = reg.gauge("rebuild.active")
        self._c_restarts = reg.counter("rebuild.restarts")
        self._c_rows = reg.counter("scrub.rows_verified")
        self._c_mismatch = reg.counter("scrub.mismatches")
        self._c_passes = reg.counter("scrub.passes")

    # -------------------------------------------------------------- spares
    def add_spare(self, device: ZonedDevice) -> None:
        with self._lock:
            self._spares.append(device)

    @property
    def spare_count(self) -> int:
        with self._lock:
            return len(self._spares)

    def _pop_spare(self) -> Optional[ZonedDevice]:
        with self._lock:
            return self._spares.pop(0) if self._spares else None

    def _rebind_monitor(self, member: int, spare: ZonedDevice) -> None:
        """Point the seat's health monitor at the spare: the dead device's
        incident key disappears from the promotion rule's view, so the
        engine publishes ``alert.resolved`` on its next evaluation."""
        if self.monitor is None or member >= len(self.monitor.members):
            return
        self.monitor.members[member] = DeviceHealthMonitor(
            spare, events=self.monitor.events,
            name=f"member{member}/dev{getattr(spare, 'dev_ordinal', member)}")

    # ----------------------------------------------------------- promotion
    def attach(self, engine, *, rule: str = "member_degraded"):
        """Wire automatic promotion into ``engine`` (an AlertEngine): a
        ``member_degraded`` alert whose incident key names ``member<i>``
        promotes a spare into seat ``i``. Idempotent per incident key — a
        re-fired or duplicated alert never double-promotes. Returns the
        unsubscribe callable."""

        def on_alert(alert) -> None:
            if alert.rule != rule:
                return
            m = _MEMBER_KEY.match(alert.key)
            if m is None:
                return
            with self._lock:
                if alert.key in self._handled:
                    return
                self._handled.add(alert.key)
            self.promote_spare(int(m.group(1)),
                               reason=f"alert {alert.rule}/{alert.key}")

        self._unsubscribe = engine.on_alert(on_alert)
        return self._unsubscribe

    def promote_spare(self, member: int, *, reason: str = "manual") -> bool:
        """Swap the next hot spare into seat ``member`` and start its
        rebuild worker. Returns False (without consuming a spare) when the
        seat already has a live rebuild or the pool is empty — the
        idempotence the alert path relies on."""
        with self._lock:
            t = self._threads.get(member)
            if t is not None and t.is_alive():
                return False
            if not self._spares:
                _publish_event(
                    "spare.exhausted", severity=_Sev.ERROR,
                    message=f"no hot spare available for member {member} "
                            f"({reason})",
                    member=member, reason=reason)
                return False
            spare = self._spares.pop(0)
            try:
                pending = self.array.replace_member(member, spare)
            except Exception:
                self._spares.insert(0, spare)   # seat refused: keep the spare
                raise
            self._rebind_monitor(member, spare)
            self._member_status[member] = {
                "state": "running", "zones_total": len(pending),
                "zones_done": 0, "zones_failed": [], "restarts": 0,
                "spare": getattr(spare, "dev_ordinal", None),
            }
            self._publish_progress()
            worker = threading.Thread(
                target=self._rebuild_member, args=(member,),
                name=f"array-rebuild-m{member}", daemon=True)
            self._threads[member] = worker
        _publish_event(
            "spare.promoted", severity=_Sev.WARNING,
            message=f"spare dev{getattr(spare, 'dev_ordinal', '?')} promoted "
                    f"into member seat {member} ({reason}): "
                    f"{len(pending)} zone(s) to rebuild",
            member=member, spare=getattr(spare, "dev_ordinal", None),
            pending=len(pending), reason=reason)
        worker.start()
        return True

    # -------------------------------------------------------------- status
    def status(self) -> dict[int, dict]:
        """Per-seat rebuild status snapshot (state / zone counts)."""
        with self._lock:
            return {m: dict(st) for m, st in self._member_status.items()}

    def rebuild_active(self) -> bool:
        with self._lock:
            return any(t.is_alive() for t in self._threads.values())

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Join every rebuild worker; True when all finished in time."""
        with self._lock:
            threads = list(self._threads.values())
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in threads:
            if deadline is None:
                t.join()
            else:
                t.join(timeout=max(0.0, deadline - time.monotonic()))
                if t.is_alive():
                    return False
        return True

    def stop(self) -> None:
        """Stop the loops (rebuild state stays restartable: marked zones
        keep their ``_rebuilding`` entries)."""
        self._stop.set()
        self.stop_scrub()
        self.wait(timeout=10.0)
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None
        self._stop.clear()

    def _publish_progress(self) -> None:
        with self._lock:
            total = sum(st.get("zones_total", 0)
                        for st in self._member_status.values())
            done = sum(st.get("zones_done", 0)
                       for st in self._member_status.values())
            active = sum(1 for t in self._threads.values() if t.is_alive())
        self._g_total.set(total)
        self._g_done.set(done)
        self._g_progress.set(done / total if total else 1.0)
        self._g_active.set(active)

    # -------------------------------------------------------------- I/O
    def _sched_io(self, io_op: str, zone_id: int, *, tenant: str,
                  block_off: int = 0, n_blocks: Optional[int] = None,
                  data=None, member: Optional[int] = None):
        """One raw I/O through the scheduler's queues, synchronously: the
        command pays its way through WRR like any tenant's traffic."""
        sched = self.scheduler
        cmd_id = sched.submit_io(
            io_op, zone_id, block_off=block_off, n_blocks=n_blocks,
            data=data, tenant=tenant, member=member, block=True,
            _watch=True)
        if sched._thread is None:
            sched.drain()
        comp = sched.wait(cmd_id)
        if comp.error is not None:
            raise comp.error
        return comp.value

    def _read_logical(self, zone_id: int, base: int, n: int) -> np.ndarray:
        """Logical-extent read (degraded reconstruction included) on the
        rebuild tenant; ``(n, block_bytes)`` uint8."""
        if self.scheduler is not None:
            flat = self._sched_io("read", zone_id, tenant=self.rebuild_tenant,
                                  block_off=base, n_blocks=n)
        else:
            flat = self.array.read_blocks(zone_id, base, n)
        return np.asarray(flat).reshape(-1, self.array.block_bytes)

    def _append_member(self, member: int, zone_id: int,
                       payload: np.ndarray) -> None:
        if self.scheduler is not None:
            self._sched_io("append", zone_id, tenant=self.rebuild_tenant,
                           data=payload, member=member)
        else:
            self.array.devices[member].submit_append(
                zone_id, payload).result()

    def _read_member(self, member: int, zone_id: int, off: int,
                     n: int) -> np.ndarray:
        if self.scheduler is not None:
            flat = self._sched_io("read", zone_id, tenant=self.scrub_tenant,
                                  block_off=off, n_blocks=n, member=member)
        else:
            flat = self.array.devices[member].read_blocks(zone_id, off, n)
        return np.asarray(flat).reshape(-1, self.array.block_bytes)

    # ------------------------------------------------------------- rebuild
    def _rebuild_member(self, member: int) -> None:
        """Worker loop for one seat: reconstruct every marked zone, commit
        each at cutover, classify failures (source double fault vs spare
        death), restart onto the next spare if this one dies."""
        arr = self.array
        st = self._member_status[member]
        while not self._stop.is_set():
            zones = sorted(z for z, m in arr.rebuilding_zones().items()
                           if m == member)
            if not zones:
                break
            zone_id = zones[0]
            try:
                self._rebuild_zone(member, zone_id)
            except _SourceStopped:
                # stop(): the zone keeps its _rebuilding mark (partial copy
                # re-parked at the next begin_member_rebuild) — restartable
                with self._lock:
                    st["state"] = "stopped"
                self._publish_progress()
                return
            except _SpareWriteError as e:
                if self._restart_onto_next_spare(member, e):
                    st["restarts"] += 1
                    self._c_restarts.inc()
                    continue
                # pool empty: park every remaining marked zone and stop
                for z in zones:
                    arr.abandon_member_rebuild(z)
                st["state"] = "failed"
                st["zones_failed"].extend(zones)
                _publish_event(
                    "rebuild.failed", severity=_Sev.ERROR,
                    message=f"rebuild of member {member} failed (spare died, "
                            f"pool empty): {len(zones)} zone(s) abandoned",
                    member=member, zones=zones, error=str(e.__cause__ or e))
                self._publish_progress()
                return
            except Exception as e:
                # source-side failure: the survivors can no longer produce
                # this zone's bytes (xor double fault). Abandon THIS zone —
                # it goes OFFLINE through the redundancy math — and keep
                # rebuilding the rest.
                arr.abandon_member_rebuild(zone_id)
                st["zones_failed"].append(zone_id)
                _publish_event(
                    "rebuild.zone_failed", severity=_Sev.ERROR,
                    message=f"zone {zone_id} rebuild onto member {member} "
                            f"abandoned (source unrecoverable): {e}",
                    zone=zone_id, member=member, error=type(e).__name__)
            else:
                st["zones_done"] += 1
            self._publish_progress()
        with self._lock:
            if st["state"] == "running":
                left = [z for z, m in arr.rebuilding_zones().items()
                        if m == member]
                st["state"] = "stopped" if left else (
                    "degraded" if st["zones_failed"] else "complete")
        self._publish_progress()
        _publish_event(
            "rebuild.finished",
            severity=_Sev.INFO if not st["zones_failed"] else _Sev.WARNING,
            message=f"member {member} rebuild {st['state']}: "
                    f"{st['zones_done']} zone(s) rebuilt, "
                    f"{len(st['zones_failed'])} abandoned",
            member=member, state=st["state"], zones_done=st["zones_done"],
            zones_failed=list(st["zones_failed"]))

    def _rebuild_zone(self, member: int, zone_id: int) -> None:
        arr = self.array
        member_idx, wp = arr.begin_member_rebuild(zone_id)
        assert member_idx == member
        batch = self.rows_per_io * arr.stripe_blocks * arr.data_columns
        base = 0
        while base < wp:
            if self._stop.is_set():
                raise _SourceStopped(f"rebuild stopped at zone {zone_id}")
            n = min(batch, wp - base)
            logical = self._read_logical(zone_id, base, n)
            shard = arr.member_shard(member, logical, base_block=base)
            if len(shard):
                try:
                    self._append_member(member, zone_id, shard)
                except (ZNSError, OSError) as e:
                    raise _SpareWriteError(
                        f"spare write failed on zone {zone_id}") from e
            base += n
        arr.commit_member_rebuild(zone_id)

    def _restart_onto_next_spare(self, member: int, cause: Exception) -> bool:
        """The spare itself died mid-rebuild: swap in the next one (the
        marked zones carry over; committed-then-lost zones re-enter the
        pending set via replace_member) and keep the same worker going."""
        with self._lock:
            spare = self._pop_spare()
            if spare is None:
                return False
            try:
                pending = self.array.replace_member(member, spare)
            except Exception:
                self._spares.insert(0, spare)
                return False
            self._rebind_monitor(member, spare)
            st = self._member_status[member]
            st["zones_total"] = st["zones_done"] + len(pending)
            st["spare"] = getattr(spare, "dev_ordinal", None)
        _publish_event(
            "rebuild.restarted", severity=_Sev.WARNING,
            message=f"member {member} rebuild restarted onto spare "
                    f"dev{getattr(spare, 'dev_ordinal', '?')} after the "
                    f"previous spare failed: {cause.__cause__ or cause}",
            member=member, spare=getattr(spare, "dev_ordinal", None),
            pending=len(pending))
        return True

    # --------------------------------------------------------------- scrub
    def scrub(self, zones: Optional[Sequence[int]] = None) -> dict:
        """One full verification pass: every complete stripe row of every
        healthy zone is read back per member (low-priority ``scrub``
        tenant) and checked — raid1 partners byte-equal, xor rows XOR to
        zero, the tail row consistent with the host parity accumulator.
        Mismatches publish ``scrub.mismatch`` and charge
        ``scrub_mismatches`` on the implicated devices (the health monitor
        counts them as media errors). Degraded / rebuilding / raid0 zones
        are skipped — there is nothing redundant to cross-check. Returns
        ``{rows_verified, mismatches, zones_scrubbed, zones_skipped}``."""
        arr = self.array
        result = {"rows_verified": 0, "mismatches": 0,
                  "zones_scrubbed": 0, "zones_skipped": 0}
        if arr.redundancy == "raid0":
            result["zones_skipped"] = arr.num_zones
            return result
        s, C = arr.stripe_blocks, arr.data_columns
        for z in (range(arr.num_zones) if zones is None else zones):
            if self._stop.is_set():
                break
            with arr._lock:
                wp = arr._wp[z]
                skip = (z in arr._rebuilding
                        or bool(arr._offline_members(z)))
                tp = arr.tail_parity(z) if not skip else None
            if wp == 0:
                continue
            if skip:
                result["zones_skipped"] += 1
                continue
            mm = self._scrub_zone(z, wp, tp, s, C, result)
            result["mismatches"] += mm
            result["zones_scrubbed"] += 1
        self._c_passes.inc()
        return result

    def _scrub_zone(self, z: int, wp: int, tail_parity, s: int, C: int,
                    result: dict) -> int:
        """Verify one zone against snapshot ``wp``/``tail_parity`` (taken
        under the array lock — data below ``wp`` is immutable, so the reads
        need no lock). Returns the mismatch count."""
        arr = self.array
        mismatches = 0
        full_rows, rem = divmod(wp, s * C)
        batch_rows = max(self.rows_per_io, 1)
        for row0 in range(0, full_rows, batch_rows):
            k = min(batch_rows, full_rows - row0)
            spans = [self._read_member(i, z, row0 * s, k * s)
                     for i in range(arr.n_devices)]
            if arr.redundancy == "raid1":
                for c in range(C):
                    a, b = spans[2 * c], spans[2 * c + 1]
                    if not np.array_equal(a, b):
                        for r in range(k):
                            if not np.array_equal(a[r * s:(r + 1) * s],
                                                  b[r * s:(r + 1) * s]):
                                mismatches += 1
                                self._report_mismatch(
                                    z, row0 + r, [2 * c, 2 * c + 1],
                                    "mirror halves differ")
            else:
                acc = spans[0].copy()
                for sp in spans[1:]:
                    acc ^= sp
                if acc.any():
                    bad = acc.reshape(k, s, -1).any(axis=(1, 2))
                    for r in np.flatnonzero(bad):
                        row = row0 + int(r)
                        mismatches += 1
                        self._report_mismatch(
                            z, row, list(range(arr.n_devices)),
                            "row XOR is nonzero (parity inconsistent)")
            self._c_rows.inc(k)
            result["rows_verified"] += k
        if rem:
            mismatches += self._scrub_tail(z, full_rows, rem, tail_parity,
                                           s, C, result)
        return mismatches

    def _scrub_tail(self, z: int, row: int, rem: int, tail_parity,
                    s: int, C: int, result: dict) -> int:
        """Verify the incomplete tail row: raid1 compares the partners'
        landed spans; xor XORs the landed data spans against the host
        parity-accumulator snapshot (the value the row's parity chunk will
        have). Returns the mismatch count."""
        arr = self.array
        rem_chunks, partial = divmod(rem, s)

        def tail(col: int) -> int:
            if col < rem_chunks:
                return s
            return partial if col == rem_chunks else 0

        mismatches = 0
        if arr.redundancy == "raid1":
            for c in range(C):
                t = tail(c)
                if not t:
                    continue
                a = self._read_member(2 * c, z, row * s, t)
                b = self._read_member(2 * c + 1, z, row * s, t)
                if not np.array_equal(a, b):
                    mismatches += 1
                    self._report_mismatch(
                        z, row, [2 * c, 2 * c + 1],
                        "tail-row mirror halves differ")
        else:
            if tail_parity is None:
                return 0            # accumulator lost at recovery: unverifiable
            data_devs, _parity = arr._row_devices(row)
            acc = np.zeros((s, arr.block_bytes), np.uint8)
            for c in range(C):
                t = tail(c)
                if not t:
                    continue
                acc[:t] ^= self._read_member(data_devs[c], z, row * s, t)
            if not np.array_equal(acc, tail_parity):
                mismatches += 1
                self._report_mismatch(
                    z, row, [data_devs[c] for c in range(C) if tail(c)],
                    "tail-row data disagrees with the parity accumulator")
        self._c_rows.inc(1)
        result["rows_verified"] += 1
        return mismatches

    def _report_mismatch(self, zone_id: int, row: int, members: list[int],
                         detail: str) -> None:
        self._c_mismatch.inc()
        for m in members:
            dev = self.array.devices[m]
            try:
                dev.metrics.counter("scrub_mismatches").inc()
            except Exception:
                pass
        _publish_event(
            "scrub.mismatch", severity=_Sev.ERROR,
            message=f"scrub: zone {zone_id} stripe row {row} inconsistent "
                    f"({detail}; members {members})",
            zone=zone_id, row=row, members=members,
            redundancy=self.array.redundancy)

    def start_scrub(self, interval: float = 5.0) -> None:
        """Run :meth:`scrub` every ``interval`` seconds on a daemon thread
        (the cadence knob the README documents)."""
        if self._scrub_thread is not None and self._scrub_thread.is_alive():
            return
        self._scrub_stop = threading.Event()

        def loop() -> None:
            while not self._scrub_stop.wait(interval):
                self.scrub()

        self._scrub_thread = threading.Thread(
            target=loop, name="array-scrub", daemon=True)
        self._scrub_thread.start()

    def stop_scrub(self) -> None:
        t = self._scrub_thread
        if t is not None:
            self._scrub_stop.set()
            t.join(timeout=5.0)
            self._scrub_thread = None


class _SpareWriteError(Exception):
    """Internal: the spare (copy target) failed — restart onto the next."""


class _SourceStopped(Exception):
    """Internal: stop() interrupted a zone copy (zone stays restartable)."""
