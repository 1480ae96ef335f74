"""Power-loss crash-consistency harness for the zoned checkpoint store.

The atomic-commit claim of :class:`repro_torch.train.ZonedCheckpointStore` is that
a checkpoint exists exactly when its manifest append is durable — payload
appends land first, the manifest lands last, and recovery takes the newest
manifest whose payload verifies. :class:`PowerLossHarness` tests that claim
*exhaustively* instead of at a few hand-picked points:

  1. run a scripted sequence of checkpoint saves against a live striped
     store while journaling every **member-device append completion** (the
     emulator's unit of durability — one journal entry per member chunk, in
     retirement order);
  2. for every prefix ``journal[:k]`` — i.e. *power loss between any two
     append completions*, including ``k=0`` (loss before anything landed)
     and mid-stripe cuts where one mirror of a pair has the manifest and the
     other does not — rebuild a fresh set of member files containing exactly
     those ``k`` completed appends and nothing else;
  3. reopen the truncated store through the normal recovery scan and demand
     one of exactly two outcomes: a **bit-exact restore** of some checkpoint
     between ``lo(k)`` (the newest save *fully* durable at the cut) and
     ``hi(k)`` (the newest save whose manifest had *started* landing — a
     half-mirrored commit record may legitimately be readable), or a **clean
     refusal** (``CheckpointError``) only while no save is fully durable.
     A torn restore — wrong step, wrong bytes, or an unhandled crash in
     recovery — fails the whole sweep.

The harness is deterministic: member completions retire in virtual-time
order, so the journal (and therefore the boundary set) is identical across
runs with the same inputs.

The port of :mod:`repro.faults.crash`: trees hold torch tensors (on any
device) or numpy arrays, and every store of the sweep restores onto
``torch_device`` (the card unless the caller passes ``"cpu"``).
"""
from __future__ import annotations

import json
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Optional, Sequence

import numpy as np

from repro_torch._device import resolve_device

__all__ = ["PowerLossHarness", "CrashOutcome", "CrashConsistencyError"]


class CrashConsistencyError(AssertionError):
    """A crash boundary recovered to a torn/impossible state."""


@dataclass(frozen=True)
class CrashOutcome:
    """Result of recovery at one power-loss boundary.

    ``boundary`` is the number of member append completions that were
    durable at the cut; ``recovered_step`` is what recovery restored
    (``None`` on refusal); ``lo``/``hi`` bound the steps recovery was
    allowed to yield; ``refused`` marks a clean ``CheckpointError``.
    """
    boundary: int
    recovered_step: Optional[int]
    lo: Optional[int]
    hi: Optional[int]
    refused: bool
    ok: bool
    detail: str = ""


@dataclass(frozen=True)
class _JournalEntry:
    member: int      # index into array.devices
    zone_id: int     # member-local zone (0 = manifest zone)
    start_rel: int   # landing block within the member zone
    nblocks: int
    step: int        # checkpoint save in flight when the append completed


def _tree_leaves(tree: Any) -> list[tuple[np.ndarray, str]]:
    """Each leaf on the host with its dtype name (a card tensor through one
    copy; bfloat16 as its uint16 bits)."""
    from repro_torch._tree import leaf_to_host, leaves
    return [leaf_to_host(x) for x in leaves(tree)]


def _trees_equal(a: Any, b: Any) -> bool:
    la, lb = _tree_leaves(a), _tree_leaves(b)
    if len(la) != len(lb):
        return False
    for (x, dx), (y, dy) in zip(la, lb):
        if x.shape != y.shape or dx != dy:
            return False
        if x.tobytes() != y.tobytes():
            return False
    return True


class PowerLossHarness:
    """Simulate power loss at every append-completion boundary of a striped
    checkpoint workload (see module docstring for the contract checked).

    Parameters mirror :meth:`ZonedCheckpointStore.striped`; ``stride``
    subsamples the boundary sweep for fast CI runs (boundary 0, every
    ``stride``-th cut, and the final boundary are always included).
    """

    def __init__(self, directory: Path | str, *, num_devices: int = 4,
                 num_zones: int = 8,
                 member_zone_bytes: int = 1 * 1024 * 1024,
                 stripe_blocks: int = 8, redundancy: str = "raid1",
                 stride: int = 1, torch_device="cuda"):
        if stride < 1:
            raise ValueError("stride must be >= 1")
        self.torch_device = resolve_device(torch_device)
        self.directory = Path(directory)
        self.num_devices = num_devices
        self.num_zones = num_zones
        self.member_zone_bytes = member_zone_bytes
        self.stripe_blocks = stripe_blocks
        self.redundancy = redundancy
        self.stride = stride
        self.journal: list[_JournalEntry] = []
        self._step_end: list[tuple[int, int]] = []  # (step, journal len after)
        self.outcomes: list[CrashOutcome] = []

    # ------------------------------------------------------------- recording
    def _record_saves(self, steps: Sequence[tuple[int, Any]]) -> None:
        from repro_torch.train.checkpoint import ZonedCheckpointStore

        live_dir = self.directory / "live"
        store = ZonedCheckpointStore.striped(
            live_dir, num_devices=self.num_devices,
            num_zones=self.num_zones,
            member_zone_bytes=self.member_zone_bytes,
            stripe_blocks=self.stripe_blocks,
            redundancy=self.redundancy,
            keep=len(steps) + 1,   # the sweep replays history; never GC it
            torch_device=self.torch_device,
        )
        self._live = store
        member_of = {id(d): i for i, d in enumerate(store.device.devices)}
        cur_step = [-1]

        def listener(device, zone_id, start_rel, nblocks, fut):
            entry = _JournalEntry(member_of[id(device)], zone_id,
                                  start_rel, nblocks, cur_step[0])

            def on_done(f):
                if f.error is None:
                    self.journal.append(entry)

            fut.add_done_callback(on_done)

        for d in store.device.devices:
            d.add_append_listener(listener)

        for step, tree in steps:
            cur_step[0] = step
            # save_async().result(), NOT save(): gc() would reset zones the
            # boundary replay still reads committed history from
            store.save_async(step, tree).result()
            self._step_end.append((step, len(self.journal)))
        store.flush()

    # ---------------------------------------------------------------- bounds
    def _bounds(self, k: int) -> tuple[Optional[int], Optional[int]]:
        """(lo, hi) recovery bounds for a cut after ``k`` completions: lo is
        the newest step fully durable (every member append, manifest
        included, in ``journal[:k]``), hi the newest step with at least one
        manifest-zone member append in ``journal[:k]`` (a partially mirrored
        commit record may still scan as valid on the surviving replica)."""
        lo = None
        for step, end in self._step_end:
            if end <= k:
                lo = step
        hi = None
        for e in self.journal[:k]:
            if e.zone_id == 0:
                hi = e.step if hi is None else max(hi, e.step)
        return lo, hi

    # ---------------------------------------------------------------- replay
    def _replay(self, k: int) -> Path:
        """Materialize member files holding exactly ``journal[:k]``."""
        from repro_torch.zns.device import ZonedDevice

        crash_dir = self.directory / f"crash{k:05d}"
        if crash_dir.exists():
            shutil.rmtree(crash_dir)
        crash_dir.mkdir(parents=True)
        shutil.copy(self.directory / "live" / "array.json",
                    crash_dir / "array.json")
        devs = [ZonedDevice(num_zones=self.num_zones,
                            zone_bytes=self.member_zone_bytes,
                            block_bytes=4096,
                            backing_file=crash_dir / f"member{i}.zns")
                for i in range(self.num_devices)]
        live_devs = self._live.device.devices
        for e in self.journal[:k]:
            z = devs[e.member].zone(e.zone_id)
            if z.write_pointer != e.start_rel:
                raise CrashConsistencyError(
                    f"journal out of order: member {e.member} zone "
                    f"{e.zone_id} wp={z.write_pointer} but entry lands at "
                    f"{e.start_rel}")
            data = live_devs[e.member].read_blocks(
                e.zone_id, e.start_rel, e.nblocks)
            landed = devs[e.member].zone_append(e.zone_id, data)
            assert landed == e.start_rel
        for d in devs:
            d.flush()
        return crash_dir

    # ------------------------------------------------------------------- run
    def _check_boundary(self, k: int, trees: dict[int, Any],
                        like: Any) -> CrashOutcome:
        from repro_torch.train.checkpoint import CheckpointError, \
            ZonedCheckpointStore

        lo, hi = self._bounds(k)
        crash_dir = self._replay(k)
        try:
            store = ZonedCheckpointStore.striped(
                crash_dir, keep=len(trees) + 1,
                torch_device=self.torch_device)
            recovered = store.latest_step()
            if recovered is None:
                try:
                    store.restore(like=like)
                    return CrashOutcome(
                        k, None, lo, hi, refused=False, ok=False,
                        detail="restore succeeded with no manifest found")
                except CheckpointError:
                    pass  # the clean refusal path
                ok = lo is None
                return CrashOutcome(
                    k, None, lo, hi, refused=True, ok=ok,
                    detail="" if ok else
                    f"refused although step {lo} was fully durable")
            try:
                tree = store.restore(step=recovered, like=like)
            except CheckpointError as e:
                # a scan-visible manifest must restore: its payload landed
                # before it (commit ordering), so a failure here is torn
                return CrashOutcome(
                    k, recovered, lo, hi, refused=True, ok=False,
                    detail=f"manifest for step {recovered} visible but "
                           f"restore refused: {e}")
            # recovery may land anywhere in [lo, hi]: above lo when a
            # half-mirrored commit record scans as valid on the surviving
            # replica (its payload is durable by commit ordering), never
            # above hi (no manifest bytes for a newer step exist on disk)
            if hi is None or recovered > hi or \
                    (lo is not None and recovered < lo):
                return CrashOutcome(
                    k, recovered, lo, hi, refused=False, ok=False,
                    detail=f"recovered step {recovered} outside durable "
                           f"bounds [{lo}, {hi}]")
            if not _trees_equal(tree, trees[recovered]):
                return CrashOutcome(
                    k, recovered, lo, hi, refused=False, ok=False,
                    detail=f"step {recovered} restored with torn bytes")
            return CrashOutcome(k, recovered, lo, hi, refused=False,
                                ok=True)
        finally:
            shutil.rmtree(crash_dir, ignore_errors=True)

    def _boundaries(self) -> list[int]:
        n = len(self.journal)
        ks = sorted(set(range(0, n + 1, self.stride)) | {0, n})
        return ks

    def run(self, steps: Sequence[tuple[int, Any]]) -> list[CrashOutcome]:
        """Save ``steps`` (``[(step, tree), ...]``, ascending) on a live
        striped store, then sweep every power-loss boundary. Returns the
        per-boundary outcomes; raises :class:`CrashConsistencyError` on the
        first contract violation (its message names the boundary)."""
        if not steps:
            raise ValueError("need at least one (step, tree) to save")
        self._record_saves(steps)
        trees = {s: t for s, t in steps}
        like = steps[0][1]
        self.outcomes = []
        for k in self._boundaries():
            out = self._check_boundary(k, trees, like)
            self.outcomes.append(out)
            if not out.ok:
                raise CrashConsistencyError(
                    f"boundary {out.boundary}/{len(self.journal)}: "
                    f"{out.detail}")
        return self.outcomes

    def summary(self) -> dict:
        """Machine-readable sweep summary (for benchmarks / CI)."""
        return {
            "journal_len": len(self.journal),
            "boundaries": len(self.outcomes),
            "refusals": sum(1 for o in self.outcomes if o.refused),
            "restores": sum(1 for o in self.outcomes
                            if o.recovered_step is not None),
            "all_ok": all(o.ok for o in self.outcomes),
        }
