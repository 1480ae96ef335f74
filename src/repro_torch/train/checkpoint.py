"""Zoned checkpoint store: fault-tolerant training state on ZNS semantics.

The checkpoint substrate is built directly on the paper's storage model:

  * **append-only**: a checkpoint is a sequence of zone appends (one record
    stream per pytree leaf) into data zones — never an in-place update;
  * **atomic commit**: the manifest (leaf index: zone/offset/shape/dtype +
    step + a payload checksum) is appended to a dedicated manifest zone
    LAST. Recovery scans the manifest zone and takes the newest manifest
    whose payload verifies — a torn/partial checkpoint (crash mid-write) is
    simply never referenced, mirroring log-structured FS commit records;
  * **host-managed GC**: freeing an old checkpoint = ``reset_zone`` on its
    data zones (the ZNS reset primitive; the device never garbage-collects
    behind the host's back);
  * **elastic restore**: leaves are stored as full logical arrays, so a
    checkpoint written on one mesh restores onto ANY mesh/sharding — the
    elastic-scaling path (grow/shrink the pod count between runs);
  * **asynchronous I/O**: ``save_async``/``restore_async`` put every leaf
    transfer in flight on the device's completion ring at once (different
    payload zones overlap on their virtual clocks) and return a
    :class:`CheckpointTicket` immediately — training steps run while
    checkpoint bytes move. Payload block offsets are taken from the append
    COMPLETIONS, exactly as real ZNS Zone Append reports the landing LBA in
    the CQ entry, and the manifest append is only submitted once every
    payload completion has retired (the commit-point ordering). Attach an
    :class:`~repro_torch.array.OffloadScheduler` and the same transfers instead
    ride a tenant's submission queue, arbitrated (WRR) against live offload
    traffic.

Host-copy accounting: ``stats["bytes_copied"]``/``stats["bytes_viewed"]``
count the store's own data movement — leaf serialization staging on save, the
single materialization copy per leaf on restore, and the manifest-scan
buffer — the checkpoint-path extension of the device-level counters.

The port of :mod:`repro.train.checkpoint`. Leaves are torch tensors (on any
device) or numpy arrays, flattened in ``jax.tree_util``'s order
(:mod:`repro_torch._tree`), so both packages write the same zones for
the same tree. A restore returns tensors on the store's ``torch_device``
(the card unless the caller passes ``"cpu"``): one host copy a leaf, then
one host-to-device copy, counted in :attr:`ZonedCheckpointStore.h2d`; a
save's device-to-host copies are counted in :attr:`ZonedCheckpointStore.d2h`.
``device=`` keeps its reference meaning: the zoned device.
"""
from __future__ import annotations

import bisect
import hashlib
import itertools
import json
import threading
import time
import weakref
import zlib
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.array import OffloadScheduler, StripedZoneArray
from repro_torch.core.csd import CopyCounter
from repro_torch.telemetry import trace as _trace
from repro_torch.telemetry.events import Severity as _Sev, publish as _publish_event
from repro_torch.telemetry.metrics import MetricsRegistry, StatsView
from repro_torch import _tree
from repro_torch.zns import CompletionBarrier, IoFuture, ZonedDevice, ZoneState

__all__ = ["ZonedCheckpointStore", "CheckpointError", "CheckpointTicket"]

MANIFEST_MAGIC = "zcsd-ckpt-v1"

_STORE_SEQ = itertools.count()


class CheckpointError(Exception):
    pass


class CheckpointTicket:
    """Handle for an in-flight asynchronous checkpoint save/restore.

    ``result()`` blocks until every underlying transfer completion has
    retired, then runs the finalize step (manifest return for saves; checksum
    verify + pytree assembly + the copies to the torch device for restores)
    in the CALLER's thread — reactor callbacks never touch the card.
    """

    def __init__(self, fut: IoFuture,
                 finalize: Optional[Callable[[Any], Any]] = None):
        self._fut = fut
        self._finalize = finalize
        self._final: Any = None
        self._finalized = False
        self._lock = threading.Lock()

    def done(self) -> bool:
        """True once every underlying transfer has retired (the finalize step
        still runs at the first ``result()``)."""
        return self._fut.done()

    def result(self, timeout: Optional[float] = None):
        raw = self._fut.result(timeout)
        if self._finalize is None:
            return raw
        with self._lock:
            if not self._finalized:
                self._final = self._finalize(raw)
                self._finalized = True
            return self._final


def _on_card(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type != "cpu"


def _leaf_to_bytes(x) -> tuple[np.ndarray, str, tuple]:
    """One leaf's bytes (a flat uint8 array the store owns), dtype name and
    shape. A card tensor's one device-to-host copy is that array; a host
    tensor or array is copied once (the reference's ``tobytes``), so a
    caller may change the leaf while the save is in flight."""
    arr, dtype = _tree.leaf_to_host(x)
    flat = arr.reshape(-1).view(np.uint8)
    return (flat if _on_card(x) else flat.copy()), dtype, arr.shape


def _leaf_from_bytes(raw, dtype: str, shape: tuple) -> torch.Tensor:
    """Materialize one leaf from a bytes-like buffer (device view or bytes)
    with exactly ONE host copy — the ``.copy()`` that detaches the leaf from
    the device's backing buffer — as a host tensor. bfloat16 is read as its
    int16 bits and viewed as ``torch.bfloat16``."""
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, np.int16).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy())


class ZonedCheckpointStore:
    """Checkpoints on a (file-backed) ZonedDevice.

    Zone 0 is the manifest zone; zones 1..N-1 hold payload. Payload zones are
    used round-robin per checkpoint generation so GC (zone reset) can reclaim
    whole generations.

    ``scheduler`` (optional) routes save/restore I/O through that scheduler's
    submission queues under ``tenant`` — checkpoint transfers then share WRR
    arbitration and SQ admission control with offload traffic instead of
    bypassing it straight to the device ring.

    ``torch_device`` is where restored leaves land (default ``"cuda"``;
    raises when CUDA is absent, so pass ``"cpu"`` for host tensors);
    ``restore``/``restore_async`` may name another.
    """

    def __init__(self, path: Optional[Path | str] = None, *,
                 device: Optional[ZonedDevice | StripedZoneArray] = None,
                 num_zones: int = 16,
                 zone_bytes: int = 256 * 1024 * 1024,
                 keep: int = 2,
                 scheduler: Optional[OffloadScheduler] = None,
                 tenant: str = "checkpoint",
                 torch_device="cuda"):
        self.torch_device = resolve_device(torch_device)
        if device is None:
            device = ZonedDevice(num_zones=num_zones, zone_bytes=zone_bytes,
                                 block_bytes=4096,
                                 backing_file=path)
        self.device = device
        self.keep = keep
        # store-level host-copy accounting (the device counters only see
        # device-side moves; serialization/materialization happen here).
        # Stores are unbounded, so the series live on a private per-store
        # registry; `stats` keeps its dict shape as a live view.
        self.metrics = MetricsRegistry(f"ckpt{next(_STORE_SEQ)}")
        self._c_bytes_copied = self.metrics.counter("bytes_copied")
        self._c_bytes_viewed = self.metrics.counter("bytes_viewed")
        self._h_save = self.metrics.histogram("save_seconds")
        self._h_restore = self.metrics.histogram("restore_seconds")
        self.stats = StatsView({"bytes_copied": self._c_bytes_copied,
                                "bytes_viewed": self._c_bytes_viewed})
        # the copies between the card and the host, and where a save's and a
        # restore's host time goes: a save copies each leaf to the host
        # (to_host: one device-to-host copy, or the host leaf's copy) and
        # runs the CRC over it (save_crc) before its appends are in flight;
        # a restore's reads are its ticket lifetime, then CRC, host copy
        # (materialize) and host-to-device copy at result()
        self.d2h, self.h2d = CopyCounter(), CopyCounter()
        self._h_phase = {name: self.metrics.histogram(f"{name}_seconds")
                         for name in ("to_host", "save_crc", "restore_crc",
                                      "materialize", "to_device")}
        self._mlock = threading.Lock()   # manifests list + placement state
        # blocks placed but whose append completion has not yet retired, per
        # zone: overlapping save_asyncs place against remaining_blocks MINUS
        # these, so queued appends can never over-commit a zone. (Released at
        # completion, so the check is conservative while transfers are in
        # flight — a spurious "no room" beats a torn zone.)
        self._reserved: dict[int, int] = {}
        # zones with in-flight checkpoint I/O (count of such operations per
        # zone): an UNCOMMITTED save's targets — its manifest does not exist
        # yet, so the live-set alone cannot protect them — and an in-flight
        # restore's sources, whose manifest a concurrent gc may evict. gc()
        # must never reset these. Held from placement/read-submission until
        # the operation's ticket settles.
        self._pinned_zones: dict[int, int] = {}
        self._scheduler: Optional[OffloadScheduler] = None
        self._tenant = tenant
        if scheduler is not None:
            self.attach_scheduler(scheduler, tenant=tenant)
        self._recover()

    def attach_scheduler(self, scheduler: OffloadScheduler, *,
                         tenant: str = "checkpoint", weight: int = 1) -> None:
        """Route subsequent save/restore I/O through ``scheduler``'s queues
        (registering ``tenant`` if needed). The scheduler must drive the same
        array this store was built over."""
        if scheduler.array is not self.device:
            raise CheckpointError(
                "scheduler drives a different device than this store")
        if tenant not in scheduler._pairs:
            scheduler.register_tenant(tenant, weight=weight)
        self._scheduler = scheduler
        self._tenant = tenant

    @classmethod
    def striped(cls, directory: Path | str, *, num_devices: int = 4,
                num_zones: int = 16,
                member_zone_bytes: int = 64 * 1024 * 1024,
                stripe_blocks: int = 256, keep: int = 2,
                redundancy: str = "raid0",
                fault_injector=None, retry_policy=None,
                torch_device="cuda",
                ) -> "ZonedCheckpointStore":
        """Checkpoint store over a striped array of file-backed ZNS devices.

        Leaf payloads stripe across ``num_devices`` member files
        (``directory/member{i}.zns``) in ``stripe_blocks``-block chunks —
        save/restore bandwidth aggregates over every member, and a reopened
        store recovers the striped manifests exactly like the single-device
        path (the logical zone's write pointer distributes to the members).
        With ``redundancy`` ``"raid1"`` or ``"xor"`` a checkpoint written
        healthy restores bit-identically even after a member zone goes
        OFFLINE mid-restore — the array reconstructs the dead member's
        chunks from the mirror partner / the surviving row members on the
        same completion ring the restore reads ride.

        The array geometry (redundancy mode included) is persisted to
        ``directory/array.json`` on first use and ADOPTED on reopen — a
        stale geometry would de-interleave member blocks in the wrong order
        and render every checkpoint unreadable, so the sidecar, not the
        arguments, is the truth for an existing store.

        ``fault_injector``/``retry_policy`` arm every member device with the
        fault-injection machinery (keyed by member index, the stable
        identity fault schedules replay under) — checkpoint saves then ride
        the same retry/timeout datapath as any other array traffic.
        """
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        sidecar = directory / "array.json"
        geometry = {
            "num_devices": num_devices, "num_zones": num_zones,
            "member_zone_bytes": member_zone_bytes,
            "stripe_blocks": stripe_blocks,
            "redundancy": redundancy,
        }
        if sidecar.exists():
            geometry = json.loads(sidecar.read_text())
        else:
            sidecar.write_text(json.dumps(geometry))
        devices = [
            ZonedDevice(num_zones=geometry["num_zones"],
                        zone_bytes=geometry["member_zone_bytes"],
                        block_bytes=4096,
                        backing_file=directory / f"member{i}.zns",
                        fault_injector=fault_injector, fault_key=i,
                        retry_policy=retry_policy)
            for i in range(geometry["num_devices"])
        ]
        array = StripedZoneArray(devices,
                                 stripe_blocks=geometry["stripe_blocks"],
                                 redundancy=geometry.get("redundancy",
                                                         "raid0"))
        return cls(device=array, keep=keep, torch_device=torch_device)

    # ----------------------------------------------------------- I/O routing
    def _io_append(self, zone_id: int, raw: bytes,
                   cb: Callable[[Optional[BaseException], Any], None]) -> None:
        """Submit one payload append on the configured path — scheduler SQ
        (overlapping with offload traffic under WRR) or the device ring
        directly. ``cb(error, landed_block)`` fires when the completion
        retires. Queue submission BLOCKS on a full SQ rather than raising:
        called from the saver's thread while the dispatcher keeps draining,
        so a checkpoint with more leaves than the queue depth is admitted in
        waves instead of failing. (The SQ bounds queued commands — dispatch
        forwards to the ring without blocking, so in-flight transfer count is
        bounded by the device's zone clocks, not the queue depth.)"""
        if self._scheduler is not None:
            self._scheduler.start()   # idempotent; queued I/O needs a pump
            self._scheduler.submit_io(
                "append", zone_id, data=np.frombuffer(raw, np.uint8),
                tenant=self._tenant, block=True,
                on_complete=lambda comp: cb(comp.error, comp.value))
        else:
            self.device.submit_append(zone_id, raw).add_done_callback(
                lambda f: cb(f.error, f._value))

    def _io_read(self, zone_id: int, block_off: int, nblocks: int,
                 cb: Callable[[Optional[BaseException], Any], None]) -> None:
        if self._scheduler is not None:
            self._scheduler.start()
            self._scheduler.submit_io(
                "read", zone_id, block_off=block_off, n_blocks=nblocks,
                tenant=self._tenant, block=True,
                on_complete=lambda comp: cb(comp.error, comp.value))
        else:
            self.device.submit_read(zone_id, block_off, nblocks) \
                .add_done_callback(lambda f: cb(f.error, f._value))

    # --------------------------------------------------------------- write
    def save(self, step: int, tree: Any) -> dict:
        """Append a checkpoint synchronously; returns its manifest. The
        payload transfers still move through the completion ring in parallel
        (distinct payload zones overlap) — this just blocks at the commit
        point, then garbage-collects."""
        manifest = self.save_async(step, tree).result()
        self.gc()
        return manifest

    def save_async(self, step: int, tree: Any) -> CheckpointTicket:
        """Put a whole checkpoint's appends in flight and return immediately.

        Per-leaf landing blocks are read from the append COMPLETIONS (the
        ZNS Zone Append contract: the LBA arrives in the CQ entry), the
        manifest append is submitted only after every payload completion has
        retired, and the ticket resolves with the manifest once the commit
        record is durable. GC is deliberately NOT run here — call
        :meth:`gc` (or use :meth:`save`) from the training thread.
        """
        t0 = time.monotonic()
        leaves, treedef = _tree.flatten_with_path(tree)
        payloads: list[tuple[str, np.ndarray, str, tuple]] = []
        crc = 0
        t_copy = t_crc = 0.0
        for path_, leaf in leaves:
            t = time.monotonic()
            raw, dtype, shape = _leaf_to_bytes(leaf)
            t_copy += time.monotonic() - t
            if _on_card(leaf):
                self.d2h.add(len(raw))
            t = time.monotonic()
            crc = zlib.crc32(raw, crc)
            t_crc += time.monotonic() - t
            self._c_bytes_copied.inc(len(raw))   # serialization staging
            payloads.append((_tree.keystr(path_), raw, dtype, shape))
        self._h_phase["to_host"].observe(t_copy)
        self._h_phase["save_crc"].observe(t_crc)

        ticket_fut = IoFuture(op="ckpt-save")
        n = len(payloads)
        # barrier lifetime (serialization -> commit-record durable) as a span
        # on the shared monotonic clock, so checkpoint saves line up against
        # device/offload tracks in the exported trace
        ticket_fut.add_done_callback(
            lambda f: self._observe_ticket("save", t0, f, step=step,
                                           leaves=n))
        entries: list[Optional[dict]] = [None] * n
        save_zones: list[int] = []   # uncommitted-zone guard, released at settle

        def on_payload(i: int, err: Optional[BaseException], landed) -> None:
            e = entries[i]
            nblocks = -(-e["bytes"] // self.device.block_bytes)
            with self._mlock:
                self._reserved[e["zone"]] -= nblocks   # transfer settled
            if err is None:
                e["block"] = int(landed)
            barrier.settle(i, err)

        # placement: chosen against live zone metadata MINUS the in-flight
        # reservations under the store lock; with direct ring routing member
        # metadata advances at submission, so consecutive leaves stack
        # correctly. (Queue routing defers the append to dispatch; the
        # landing block is still exact — it comes from the completion — and
        # the FIFO SQ preserves this save's append order.)
        with self._mlock:
            zone_ids = self._pick_payload_zones()
            placed_blocks: list[tuple[int, int]] = []   # rollback on failure
            zi = 0
            try:
                for i, (path_str, raw, dtype, shape) in enumerate(payloads):
                    nblocks = -(-len(raw) // self.device.block_bytes)
                    placed = False
                    for attempt in range(len(zone_ids)):
                        zid = zone_ids[(zi + attempt) % len(zone_ids)]
                        z = self.device.zone(zid)
                        if z.is_writable and nblocks + \
                                self._reserved.get(zid, 0) <= z.remaining_blocks:
                            zi = (zi + attempt) % len(zone_ids)
                            self._reserved[zid] = \
                                self._reserved.get(zid, 0) + nblocks
                            placed_blocks.append((zid, nblocks))
                            entries[i] = {
                                "path": path_str, "zone": zid, "block": -1,
                                "bytes": len(raw), "dtype": dtype,
                                "shape": list(shape),
                            }
                            placed = True
                            break
                    if not placed:
                        raise CheckpointError(
                            "no payload zone has room; raise num_zones")
            except BaseException:
                for zid, nblocks in placed_blocks:
                    self._reserved[zid] -= nblocks
                raise
            save_zones.extend({zid for zid, _ in placed_blocks})
            for zid in save_zones:
                self._pinned_zones[zid] = self._pinned_zones.get(zid, 0) + 1

        barrier = CompletionBarrier(
            n, lambda _vals, err: self._commit(step, entries, crc, treedef,
                                               err, save_zones, ticket_fut))
        for i, (path_str, raw, dtype, shape) in enumerate(payloads):
            try:
                self._io_append(entries[i]["zone"], raw,
                                lambda err, landed, i=i:
                                on_payload(i, err, landed))
            except BaseException as e:
                # a failed submission settles this leaf with an error: the
                # barrier still fires and the ticket fails loudly instead of
                # hanging (earlier leaves' completions drain normally)
                on_payload(i, e, None)
        return CheckpointTicket(ticket_fut)

    def _observe_ticket(self, op: str, t0: float,
                        fut: Optional[IoFuture] = None, **tags) -> None:
        """Record one async ticket's barrier lifetime (submission entry to
        last completion retired) — runs on whichever thread settles the
        final transfer, so it must stay allocation-light."""
        dt = time.monotonic() - t0
        (self._h_save if op == "save" else self._h_restore).observe(dt)
        if _trace.enabled():
            _trace.event_complete(f"ckpt.{op}", t0, dt, track="checkpoint",
                                  **tags)
        if fut is not None and fut.error is not None:
            # failed tickets surface in the operator event stream too, not
            # only to the caller holding the ticket
            _publish_event(
                "ckpt.ticket_failed", severity=_Sev.ERROR,
                message=f"checkpoint {op} ticket failed after {dt:.3f}s: "
                        f"{fut.error}",
                op=op, error=type(fut.error).__name__, **tags)

    def _release_pins(self, zones: list[int]) -> None:
        with self._mlock:
            for zid in zones:
                self._pinned_zones[zid] -= 1

    def _commit(self, step: int, entries, crc: int, treedef,
                error: Optional[BaseException], save_zones: list[int],
                ticket_fut: IoFuture) -> None:
        """The commit point: every payload completion has retired. Submit the
        manifest append; the checkpoint exists once ITS completion retires.

        The manifest goes STRAIGHT to the device ring, never through the
        scheduler queues: this may run on the dispatcher's own thread (an
        inline payload completion), where blocking on a full SQ would
        deadlock the dispatcher against itself — and the commit record is
        metadata-sized, so there is nothing for the arbiter to meter. The
        payload barrier already guarantees commit ordering on either path.
        Any failure here (e.g. a full manifest zone) fails the ticket — a
        callback context must surface errors through the ticket, not raise.
        Every terminal branch releases the save's zone pins.
        """
        if error is not None:
            self._release_pins(save_zones)
            ticket_fut.fail(error)
            return
        try:
            manifest = {
                "magic": MANIFEST_MAGIC, "step": int(step),
                "entries": entries, "crc32": crc,
                "treedef": str(treedef),
            }
            raw = json.dumps(manifest).encode()
            header = len(raw).to_bytes(8, "little") \
                + hashlib.sha256(raw).digest()

            def on_manifest(f: IoFuture) -> None:
                self._release_pins(save_zones)
                if f.error is not None:
                    ticket_fut.fail(f.error)
                    return
                with self._mlock:
                    # overlapping save_asyncs may commit out of step order
                    # (a small step-2 can retire before a fat step-1): keep
                    # the list sorted by step so latest_step()/restore(None)/
                    # gc(keep=...) mean "newest STEP", not "last to land"
                    bisect.insort(self._manifests, manifest,
                                  key=lambda m: m["step"])
                ticket_fut.complete(manifest)

            self.device.submit_append(0, header + raw) \
                .add_done_callback(on_manifest)
        except BaseException as e:
            self._release_pins(save_zones)
            ticket_fut.fail(e)

    def _pick_payload_zones(self) -> list[int]:
        ids = [z.zone_id for z in self.device.zones[1:]
               if z.state in (ZoneState.EMPTY, ZoneState.OPEN)]
        if not ids:
            raise CheckpointError("no writable payload zones (GC needed)")
        # prefer empty zones so each generation owns whole zones
        ids.sort(key=lambda i: (self.device.zone(i).write_pointer, i))
        return ids

    # ---------------------------------------------------------------- read
    def _recover(self) -> None:
        """Scan the manifest zone for valid commit records (crash recovery).
        Covers both the live-device case and a file-backed reopen, where the
        zone metadata is volatile and the log is the truth."""
        self._manifests: list[dict] = []
        self._scan_raw_manifest_zone()
        # the manifest log is in commit order; overlapping async saves may
        # have committed out of step order — normalize (stable, so same-step
        # rewrites keep the later commit last, as _find_manifest expects)
        self._manifests.sort(key=lambda m: m["step"])

    def _scan_raw_manifest_zone(self) -> None:
        bb = self.device.block_bytes
        z = self.device.zone(0)
        # read every block that may contain manifests
        max_blocks = z.write_pointer if z.write_pointer else z.capacity_blocks
        if z.write_pointer == 0:
            z.write_pointer = z.capacity_blocks  # allow raw scan
            raw = self.device.read_blocks_view(0, 0, max_blocks or z.capacity_blocks)
            z.write_pointer = 0
        else:
            raw = self.device.read_blocks_view(0, 0, z.write_pointer)
        self._c_bytes_viewed.inc(raw.nbytes)
        buf = raw.tobytes()    # the one copy: bytes for the header parser
        self._c_bytes_copied.inc(len(buf))
        off = 0
        found_blocks = 0
        while off + 40 <= len(buf):
            ln = int.from_bytes(buf[off : off + 8], "little")
            if ln == 0 or ln > 64 * 1024 * 1024 or off + 40 + ln > len(buf):
                # skip to next block boundary
                off = ((off // bb) + 1) * bb
                if off >= len(buf):
                    break
                continue
            digest = buf[off + 8 : off + 40]
            body = buf[off + 40 : off + 40 + ln]
            if hashlib.sha256(body).digest() == digest:
                try:
                    m = json.loads(body)
                    if m.get("magic") == MANIFEST_MAGIC:
                        self._manifests.append(m)
                        found_blocks = -(-(off + 40 + ln) // bb)
                except json.JSONDecodeError:
                    pass
                off = ((off + 40 + ln + bb - 1) // bb) * bb
            else:
                off = ((off // bb) + 1) * bb
        if z.write_pointer == 0 and found_blocks:
            # restore the manifest zone's write pointer after a reopen
            z.write_pointer = found_blocks
            z.state = ZoneState.OPEN
        # restore payload zone write pointers from the surviving manifests —
        # ONE assignment per zone (max over its entries), not one per entry:
        # on a striped array the setter redistributes every member write
        # pointer (and under xor re-reads the tail row into the parity
        # accumulator), so per-entry assignment would repeat that work
        # O(entries) times
        ends: dict[int, int] = {}
        for m in self._manifests:
            for e in m["entries"]:
                end = e["block"] + -(-e["bytes"] // bb)
                if end > ends.get(e["zone"], 0):
                    ends[e["zone"]] = end
        for zid, end in ends.items():
            zz = self.device.zone(zid)
            if end > zz.write_pointer:
                zz.write_pointer = end
                if zz.state == ZoneState.EMPTY:
                    zz.state = ZoneState.OPEN

    def latest_step(self) -> Optional[int]:
        return self._manifests[-1]["step"] if self._manifests else None

    def steps(self) -> list[int]:
        return [m["step"] for m in self._manifests]

    def _find_manifest_locked(self, step: Optional[int]) -> dict:
        """Manifest lookup; caller holds ``_mlock``."""
        if not self._manifests:
            raise CheckpointError("no checkpoints found")
        manifest = self._manifests[-1] if step is None else next(
            (m for m in reversed(self._manifests) if m["step"] == step),
            None)
        if manifest is None:
            raise CheckpointError(
                f"step {step} not found; have "
                f"{[m['step'] for m in self._manifests]}")
        return manifest

    def _find_manifest(self, step: Optional[int]) -> dict:
        with self._mlock:
            return self._find_manifest_locked(step)

    def restore(self, step: Optional[int] = None, *, like: Any = None,
                shardings: Any = None, torch_device=None) -> Any:
        """Restore a checkpoint as a pytree (synchronous shim over
        :meth:`restore_async`: every leaf read is in flight at once — payload
        zones overlap on their virtual clocks — and this blocks at the join).

        ``like`` supplies the treedef (e.g. abstract state); each leaf lands
        on ``torch_device`` (default: the store's). ``shardings`` has no
        counterpart in the port until it has a device mesh, and raises.
        """
        return self.restore_async(step, like=like, shardings=shardings,
                                  torch_device=torch_device).result()

    def restore_async(self, step: Optional[int] = None, *, like: Any = None,
                      shardings: Any = None,
                      torch_device=None) -> CheckpointTicket:
        """Put every leaf's read in flight and return a ticket; the checksum
        verify, pytree assembly and the copies to ``torch_device`` run in the
        caller's thread at ``result()`` time."""
        if shardings is not None:
            raise NotImplementedError(
                "shardings: the port restores onto one torch device; "
                "sharded restore waits for the port of repro.sharding")
        dest = self.torch_device if torch_device is None \
            else resolve_device(torch_device)
        if like is None:
            raise CheckpointError("restore requires `like` for the treedef")
        t0 = time.monotonic()
        ticket_fut = IoFuture(op="ckpt-restore")
        # Manifest lookup and source-zone pinning happen under ONE _mlock
        # critical section: gc() also sweeps under it, so there is no window
        # where the manifest is found but its zones can still be reset. The
        # pin holds for the restore's lifetime — a concurrent save() may
        # evict this manifest, at which point only the pin stops the sweep
        # from resetting the zones under our in-flight reads and zero-copy
        # views. Released once: at failure, after finalize has detached
        # every leaf from the device buffer, or when an unfinalized ticket
        # is garbage-collected (abandoned after a result() timeout).
        with self._mlock:
            manifest = self._find_manifest_locked(step)
            entries = manifest["entries"]
            restore_zones = sorted({e["zone"] for e in entries})
            for zid in restore_zones:
                self._pinned_zones[zid] = self._pinned_zones.get(zid, 0) + 1
        released = [False]

        def release_once() -> None:
            with self._mlock:
                if released[0]:
                    return
                released[0] = True
                for zid in restore_zones:
                    self._pinned_zones[zid] -= 1

        def on_done(parts, err: Optional[BaseException]) -> None:
            if err is not None:
                release_once()
                ticket_fut.fail(err)
            else:
                ticket_fut.complete(parts)

        barrier = CompletionBarrier(len(entries), on_done)

        def finalize(raw_parts: list[np.ndarray]) -> Any:
            arrays = []
            crc = 0
            t_crc = t_copy = 0.0
            try:
                for e, raw in zip(entries, raw_parts):
                    raw = np.asarray(raw).reshape(-1)[: e["bytes"]]
                    self._c_bytes_viewed.inc(raw.nbytes)
                    t = time.monotonic()
                    crc = zlib.crc32(raw, crc)
                    t_crc += time.monotonic() - t
                    t = time.monotonic()
                    arrays.append(
                        _leaf_from_bytes(raw, e["dtype"], tuple(e["shape"])))
                    t_copy += time.monotonic() - t
                    self._c_bytes_copied.inc(arrays[-1].nbytes)
            finally:
                # every leaf is now an owned copy (or we are failing): the
                # device zones may be recycled
                release_once()
            self._h_phase["restore_crc"].observe(t_crc)
            self._h_phase["materialize"].observe(t_copy)
            if crc != manifest["crc32"]:
                raise CheckpointError(
                    "payload checksum mismatch (torn checkpoint?)")
            flat_like, treedef = _tree.flatten(like)
            if len(flat_like) != len(arrays):
                raise CheckpointError(
                    f"leaf count mismatch: ckpt {len(arrays)} vs like "
                    f"{len(flat_like)}")
            if dest.type != "cpu":
                t = time.monotonic()
                for i, e in enumerate(entries):
                    arrays[i] = arrays[i].to(dest)
                    self.h2d.add(e["bytes"])
                torch.cuda.synchronize(dest)
                self._h_phase["to_device"].observe(time.monotonic() - t)
            return _tree.unflatten(treedef, arrays)

        for i, e in enumerate(entries):
            nblocks = -(-e["bytes"] // self.device.block_bytes)
            try:
                self._io_read(e["zone"], e["block"], nblocks,
                              lambda err, value, i=i:
                              barrier.settle(i, err, value))
            except BaseException as err:
                barrier.settle(i, err)   # settle the leaf; ticket fails loudly
        ticket_fut.add_done_callback(
            lambda f: self._observe_ticket(
                "restore", t0, f, step=manifest["step"],
                leaves=len(entries)))
        ticket = CheckpointTicket(ticket_fut, finalize)
        # abandoned ticket (e.g. result() timed out and the caller moved on):
        # the pins must not outlive it, or gc could never reclaim the zones
        weakref.finalize(ticket, release_once)
        return ticket

    # ------------------------------------------------------------------ GC
    def gc(self) -> int:
        """Host-managed GC: drop all but the newest ``keep`` checkpoints and
        reset any payload zone no longer referenced (the ZNS reset story)."""
        resets = 0
        # the reset loop runs UNDER the store lock: placement also runs under
        # it, so no save_async can claim a zone between the live-set snapshot
        # and its reset (the lock orders strictly before the device lock
        # reset_zone takes; nothing takes them in the other order)
        with self._mlock:
            if len(self._manifests) <= self.keep:
                return 0
            self._manifests = self._manifests[-self.keep:]
            live = {(e["zone"]) for m in self._manifests for e in m["entries"]}
            # zones with in-flight checkpoint I/O — an uncommitted save's
            # targets or an active restore's sources — must survive the sweep
            live |= {zid for zid, n in self._pinned_zones.items() if n > 0}
            for z in self.device.zones[1:]:
                if z.zone_id not in live and z.write_pointer > 0:
                    self.device.reset_zone(z.zone_id)
                    resets += 1
        return resets

    def flush(self) -> None:
        self.device.flush()
