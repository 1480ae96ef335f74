"""Offload scheduler: verified programs fanned out across a striped array.

The single-device ``NvmCsd`` verifies and executes one extent synchronously.
The :class:`OffloadScheduler` scales that contract to a
:class:`~repro_torch.array.striping.StripedZoneArray`:

  1. **verify once** — the program is checked by the same static verifier
     against the whole logical extent *before* it enters a submission queue;
     everything past the SQ is admitted work;
  2. **queue + arbitrate** — commands sit in per-tenant NVMe-style SQs with
     depth limits and are dispatched by weighted round-robin (see
     :mod:`repro_torch.array.queues`);
  3. **staged fan-out** — execution is an explicit three-stage pipeline
     rather than a thread per member. The READ stage submits every member
     transfer the plan needs to the completion ring UP FRONT — coalesced
     chunk-group reads per member (:func:`repro_torch.array.striping.
     coalesce_member_runs`), tail-chunk reads, xor survivor reconstructions
     — so in-flight depth is bounded by the emulated devices, not a thread
     pool (:mod:`repro_torch.zns.ring`). The COMPUTE stage is ONE dispatcher that
     consumes staged groups in logical order and issues ONE array-wide
     batched call per group over the chunks of ALL members: eager PyTorch
     over the batch on the jit tier
     (:func:`repro_torch.core.vm.jit_program_batched`) or one launch of the
     hand-written batched CUDA kernel on the kernel tier
     (:func:`repro_torch.kernels.zone_filter.ops.kernel_program_batched`) —
     never N GIL-contending per-worker dispatches. On CUDA each member run
     of a group is ONE copy from the member's page-locked zone memory
     straight into the group's batch tensor on the card, on a copy stream;
     the launch goes on a compute stream that waits for those copies and
     returns device tensors, and landing waits on an event recorded after
     the launch before it copies the few result bytes to the host;
  4. **combine stage** — per-chunk results fold in logical stripe order on
     the striping gather pool AS THEY LAND, off the straggler's critical
     path, by a program-aware combiner: SUM/COUNT re-add (float SUM via
     Kahan compensated f64 accumulation, so results are identical for
     every array width over the same logical data), MIN/MAX re-reduce, HIST
     re-accumulates, SELECT/SELECT_REC concatenate the first ``capacity``
     matches in logical order — bit-identical to the single-device result
     for COUNT/MIN/MAX/SELECT and for SUM over integer streams (float SUM
     may differ from a chunk-free single device by summation order, exactly
     as the tiers already may);
  5. **aggregate stats** — one :class:`ArrayOffloadStats` per command rolls
     up bytes read on every member, bytes returned to the host, verify/JIT/
     read/exec time, compile-cache hits, and the fan-out shape.

A 1-device array degrades to the ``NvmCsd`` semantics — the degenerate path.

``OffloadScheduler(array, device="cuda")`` computes on the card and raises
when there is none; ``device="cpu"`` runs the plain PyTorch paths. No group
falls back to another device or to a kernel's plain version: a launch that
fails fails the command.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch._device import host_tensor, resolve_device
from repro_torch.core.cache import CompiledProgramCache
from repro_torch.telemetry import trace as _trace
from repro_torch.telemetry.metrics import registry as _registry
from repro_torch.core.csd import (
    CsdTier,
    OffloadStats,
    execute_extent,
    extent_geometry,
    h2d,
    pin_array_memory,
    pin_zone_memory,
    resolve_tier,
)
from repro_torch.core.programs import OpCode, Program
from repro_torch.core.verifier import VerifierLimits, verify_program, verify_zone_access
from repro_torch.core.vm import _SUM_WIDEN, _TORCH_DTYPE, jit_program_batched
from repro_torch.array.queues import (
    Completion,
    OffloadCommand,
    QueuePair,
    CompletionQueue,
    SubmissionQueue,
    WeightedRoundRobinArbiter,
)
from repro_torch.array.striping import (
    StripeChunk,
    StripedZoneArray,
    _gather_executor,
    _off_reactor,
    coalesce_member_runs,
)
from repro_torch.faults.errors import TransientIOError
from repro_torch.zns.device import ZNSError, block_aligned_dtype

__all__ = ["OffloadScheduler", "ArrayOffloadStats", "ArrayOffloadError"]


class ArrayOffloadError(Exception):
    """A member device failed mid-offload (e.g. an OFFLINE zone). The message
    names the member so the operator can degrade/repair explicitly."""


@dataclass
class ArrayOffloadStats(OffloadStats):
    """Per-command statistics aggregated over the staged fan-out pipeline.

    ``read_seconds`` sums emulated transfer time across every member read;
    all of those transfers are in flight on the completion ring up front, so
    it may far exceed the ``exec_seconds`` wall time — the surplus IS the
    overlap. The per-stage figures (``read_wait_seconds`` /
    ``stage_seconds`` / ``compute_seconds`` / ``combine_seconds``) decompose
    where the dispatcher's wall time actually went.

    On CUDA, ``stage_seconds`` is the host time spent issuing the batch
    groups' copies to the card, ``h2d_seconds`` the copy stream's time for
    them (CUDA events) plus the blocking copies of per-chunk extents, and
    ``compute_seconds`` the batched launches' device time (CUDA events)
    plus the per-chunk executions' host time.
    """

    n_devices: int = 1
    n_chunks: int = 1
    batched_chunks: int = 0        # chunks executed via a batched compiled call
    n_dispatches: int = 0          # array-wide batched compiled calls issued
    # chunks served without their preferred member: raid1 mirror redirects
    # plus xor reconstructions (degraded offloads stay bit-identical; this
    # counter is how an operator notices the array is running degraded)
    degraded_reads: int = 0
    compute_seconds: float = 0.0   # time inside compiled/interp execution only
    read_wait_seconds: float = 0.0 # wall the compute stage BLOCKED on reads
    stage_seconds: float = 0.0     # staging copies into the batch tensor
    combine_seconds: float = 0.0   # combiner folds (run on the gather pool)
    # max(read_seconds - read_wait_seconds, 0): member transfer time the
    # pipeline hid — under compute, and under other members' transfers
    # elapsing concurrently on the ring
    overlap_seconds: float = 0.0
    # which tenant's SQ carried the command, plus that tenant's cumulative
    # accounting (bytes/ops/p50/p99/degraded_reads from the global registry)
    # as of this command's completion — the QoS view the ROADMAP asks for
    tenant: str = "default"
    tenant_totals: dict = field(default_factory=dict)

    @property
    def fanout(self) -> str:
        return (f"{self.n_chunks} chunks / {self.n_devices} devices / "
                f"{self.n_dispatches} dispatches")

    @property
    def overlap_ratio(self) -> float:
        """Fraction of member-transfer time the pipeline hid (1.0 = the
        compute stage never blocked on the ring)."""
        return min(self.overlap_seconds / self.read_seconds, 1.0) \
            if self.read_seconds > 0 else 0.0


@dataclass
class _StageAgg:
    """Accumulator for one command's pipeline counters, filled by the
    compute stage (per-chunk serving paths park values in ``vals`` until
    they are handed to the combiner)."""

    vals: dict    # chunk index -> value
    compile_s: float = 0.0
    insns: int = 0
    batched: int = 0
    dispatches: int = 0
    degraded: int = 0
    read_s: float = 0.0
    read_wait_s: float = 0.0
    stage_s: float = 0.0
    compute_s: float = 0.0
    combine_s: float = 0.0
    h2d_s: float = 0.0
    hits: int = 0
    misses: int = 0
    # CUDA (start, end) event pairs of each group's copies and launch, read
    # once every group has landed
    h2d_events: list = field(default_factory=list)
    compute_events: list = field(default_factory=list)

    def fold_result(self, result) -> None:
        """Merge one per-chunk :func:`execute_extent` result's counters."""
        self.compile_s += result.compile_seconds
        self.insns += result.insns_executed
        self.read_s += result.read_seconds
        self.compute_s += result.exec_seconds
        self.h2d_s += result.h2d_seconds
        self.hits += result.cache_hits
        self.misses += result.cache_misses

    def fold_events(self) -> None:
        """Add the device time between each recorded event pair."""
        self.h2d_s += sum(a.elapsed_time(b) for a, b in self.h2d_events) / 1e3
        self.compute_s += sum(
            a.elapsed_time(b) for a, b in self.compute_events) / 1e3


@dataclass
class _MemberRun:
    """One coalesced member read of a batch group: ``items`` are
    ``(row, chunk)`` pairs (row = slot in the group's batch buffer),
    ascending and contiguous in member-local space — ONE ring transfer.
    A run's rows are one contiguous block of the batch, so it reaches the
    card in ONE copy."""

    device: int
    items: list
    fut: object


@dataclass
class _StageGroup:
    """One batch group: the chunks that share one array-wide dispatch, and
    the member runs that read them (each run's rows a contiguous block of
    the group's batch)."""

    chunks: list
    runs: list


@dataclass
class _StagedReads:
    """Everything the READ stage put in flight, for the compute stage to
    consume: batch groups (one array-wide dispatch each), per-chunk tail
    reads, xor-reconstruction reads, and chunks whose member failed at
    submission time (re-served through the degraded path)."""

    groups: list = field(default_factory=list)
    m_b: int = 0                   # padded batch width shared by all groups
    rest: list = field(default_factory=list)      # (chunk, member fut)
    recon: list = field(default_factory=list)     # (chunk, array fut)
    fallback: list = field(default_factory=list)  # chunks to re-serve


class _StagedCombiner:
    """Order-preserving incremental combiner — the COMBINE stage.

    Folds per-chunk partials strictly in logical stripe order as they land
    (a cursor over the ready prefix), so the re-reduction is EXACTLY the
    sequential fold the per-command combiner always did — Kahan float-SUM
    compensation order included — keeping results bit-identical for every
    array width and degraded mode. :meth:`feed` schedules folding on the
    striping gather pool so combining overlaps the compute stage's next
    dispatch; :meth:`result` is the final rendezvous.
    """

    def __init__(self, program: Program, n_parts: int):
        self._program = program
        self._n = n_parts
        self._dtype = np.dtype(program.input_dtype)
        self._pending: dict[int, object] = {}
        self._next = 0
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        self.fold_seconds = 0.0
        term = program.terminal.op
        if term == OpCode.RED_COUNT:
            self._count = 0
        elif term == OpCode.RED_SUM:
            self._widen = _SUM_WIDEN[self._dtype]
            self._acc = self._widen(0)
            self._comp = self._widen(0)   # Kahan compensation (float SUM)
        elif term in (OpCode.RED_MIN, OpCode.RED_MAX):
            self._acc = None
        elif term == OpCode.RED_HIST:
            self._acc = np.zeros(program.terminal.imm[2], np.int64)
        elif term in (OpCode.SELECT, OpCode.SELECT_REC):
            self._parts: list[np.ndarray] = []
            self._filled = 0
            self._total = 0
        else:
            raise AssertionError(term)
        if n_parts == 0:
            self._done.set()

    def feed(self, parts: dict[int, object], *, inline: bool = False) -> None:
        """Hand over ``{logical position: partial}``; the ready prefix folds
        on the gather pool (or inline) as soon as it grows."""
        with self._lock:
            self._pending.update(parts)
            runnable = self._next in self._pending
        if not runnable:
            return
        if inline:
            self._fold()
        else:
            _gather_executor().submit(self._fold)

    def fail(self, e: BaseException) -> None:
        """Poison the combine: a deferred batch materialization died before
        it could feed its rows, so the rendezvous must raise, not hang."""
        self._error = e
        self._done.set()

    def _fold(self) -> None:
        done = True
        t0 = time.perf_counter()
        try:
            with self._lock:
                while self._next in self._pending:
                    self._fold_one(self._pending.pop(self._next))
                    self._next += 1
                done = self._next == self._n
                self.fold_seconds += time.perf_counter() - t0
        except BaseException as e:  # surfaced at result(), never swallowed
            self._error = e
        if done:
            self._done.set()

    def _fold_one(self, v: object) -> None:
        term = self._program.terminal.op
        if term == OpCode.RED_COUNT:
            self._count += int(v)
        elif term == OpCode.RED_SUM:
            widen = self._widen
            if np.issubdtype(widen, np.floating):
                # Kahan compensated accumulation over the per-chunk partials,
                # in logical stripe order. The partials depend only on the
                # chunk decomposition (stripe_blocks), not on how many
                # devices the chunks landed on — so with compensation the
                # re-reduction is bit-identical for every array width over
                # the same logical data.
                y = widen(np.asarray(v)[()]) - self._comp
                t = widen(self._acc + y)
                self._comp = widen((t - self._acc) - y)
                self._acc = t
            else:
                self._acc = widen(self._acc + widen(np.asarray(v)[()]))
        elif term == OpCode.RED_MIN:
            x = np.asarray(v, self._dtype)[()]
            self._acc = x if self._acc is None else np.minimum(self._acc, x)
        elif term == OpCode.RED_MAX:
            x = np.asarray(v, self._dtype)[()]
            self._acc = x if self._acc is None else np.maximum(self._acc, x)
        elif term == OpCode.RED_HIST:
            self._acc += np.asarray(v, np.int64)
        else:                       # SELECT / SELECT_REC
            cap = self._program.select_capacity
            buf, n = np.asarray(v[0]), int(v[1])
            self._total += n
            if self._filled < cap and n > 0:
                take = min(n, cap, cap - self._filled)
                self._parts.append(buf[:take])
                self._filled += take

    def result(self) -> object:
        """Block for the last fold and return the combined terminal value."""
        self._done.wait()
        if self._error is not None:
            raise self._error
        term = self._program.terminal.op
        if term == OpCode.RED_COUNT:
            return np.int64(self._count)
        if term == OpCode.RED_SUM:
            return self._acc
        if term in (OpCode.RED_MIN, OpCode.RED_MAX):
            return self._dtype.type(self._acc)
        if term == OpCode.RED_HIST:
            return self._acc
        cap = self._program.select_capacity
        if term == OpCode.SELECT_REC:
            stride = self._program.insns[0].imm[0]
            out = np.zeros((cap, stride), self._dtype)
        else:
            out = np.zeros((cap,), self._dtype)
        if self._parts:
            cat = np.concatenate(self._parts, axis=0)
            out[: cat.shape[0]] = cat
        return out, np.int64(self._total)


class _ExtentSource:
    """Duck-typed ``ZonedDevice`` over ONE reconstructed stripe chunk held in
    host memory, addressed at the chunk's member-local offsets.

    Degraded xor chunks have no single member to read from; the array's
    reconstruction (:meth:`StripedZoneArray.submit_read`) produces the bytes,
    and this adapter lets :func:`repro_torch.core.csd.execute_extent` run the SAME
    interp/jit/kernel tier code over them — so a degraded offload is
    bit-identical to the healthy one by construction, not by a parallel
    re-implementation of the tiers. It has no zone memory to page-lock, so
    on CUDA :func:`repro_torch.core.csd.stage_extent` sends its pages
    through a page-locked bounce buffer.
    """

    read_us_per_block = 0.0   # no emulation: the survivor reads already paid

    def __init__(self, block_bytes: int, base_block: int, flat: np.ndarray):
        self.block_bytes = block_bytes
        self._base = base_block
        self._flat = flat          # uint8, len == n_blocks * block_bytes

    def read_blocks_view(self, zone_id: int, block_off: int,
                         n_blocks: int) -> np.ndarray:
        lo = (block_off - self._base) * self.block_bytes
        view = self._flat[lo: lo + n_blocks * self.block_bytes].view()
        view.flags.writeable = False
        return view

    def read_extent(self, zone_id: int, block_off: int, n_blocks: int,
                    dtype) -> np.ndarray:
        dtype = block_aligned_dtype(self.block_bytes, dtype)
        return self.read_blocks_view(zone_id, block_off, n_blocks).view(dtype)


class _CardLane:
    """How a batch group reaches the compute device and runs there.

    On CUDA, every landed member run is ONE copy from its page-locked member
    buffer (:func:`~repro_torch.core.csd.pin_array_memory`) into its block
    of rows of the group's batch tensor, issued on a copy stream and counted
    in :data:`repro_torch.core.csd.h2d`; an event after the group's copies
    gates the launch, which runs on a compute stream, and an event after the
    launch is what landing waits on. The batch tensor is allocated on the
    copy stream and marked used on the compute stream, so the allocator
    hands its memory out again only after the launch has read it. On the
    CPU the same copies are host memcpys and the launch runs inline.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device=device)
            self.stream = torch.cuda.Stream(device=device)

    def stage(self, array: StripedZoneArray, ready: list, m_b: int,
              chunk_bytes: int, agg: _StageAgg) -> tuple:
        """Copy each landed ``(run, member view)`` into its rows of a new
        ``[m_b, chunk_bytes]`` byte batch: ``(batch, copied event or None)``.
        Rows no run fills (padding, a failed member's) stay unwritten; their
        outputs are discarded."""
        if not self.cuda:
            batch = torch.empty((m_b, chunk_bytes), dtype=torch.uint8)
            for run, raw in ready:
                self._copy_rows(batch, run, raw, chunk_bytes)
            return batch, None
        with torch.cuda.stream(self.copy_stream):
            batch = torch.empty((m_b, chunk_bytes), dtype=torch.uint8,
                                device=self.device)
            start = torch.cuda.Event(enable_timing=True)
            copied = torch.cuda.Event(enable_timing=True)
            start.record()
            for run, raw in ready:
                pin_zone_memory(array.devices[run.device])
                self._copy_rows(batch, run, raw, chunk_bytes)
                h2d.add(raw.nbytes)
            copied.record()
        agg.h2d_events.append((start, copied))
        return batch, copied

    def _copy_rows(self, batch: torch.Tensor, run: "_MemberRun", raw,
                   chunk_bytes: int) -> None:
        """One copy: the run's member view into its block of rows."""
        lo = run.items[0][0]
        src = host_tensor(np.asarray(raw).view(np.uint8))
        batch[lo:lo + len(run.items)].copy_(
            src.reshape(len(run.items), chunk_bytes), non_blocking=self.cuda)

    def launch(self, jp, pages: torch.Tensor, copied, agg: _StageAgg) -> tuple:
        """Launch ``jp`` over ``pages`` once the copies are in:
        ``(device result, done event or None)``."""
        if not self.cuda:
            return jp.launch(pages), None
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(copied)
            pages.record_stream(self.stream)
            begin = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            begin.record()
            out = jp.launch(pages)
            done.record()
        agg.compute_events.append((begin, done))
        return out, done


class OffloadScheduler:
    """NVMe-style scheduler over a striped zone array.

    Exposes the same part-i API as :class:`~repro_torch.core.csd.NvmCsd`
    (``nvm_cmd_bpf_run`` / ``nvm_cmd_bpf_result`` / ``run_and_fetch``) so the
    data pipeline and checkpoint store can treat a whole array as one CSD,
    plus the queued API (``submit`` / ``drain`` / ``start`` / ``wait``).

    ``device`` is where the jit and kernel tiers compute (default
    ``"cuda"``; it raises when CUDA is absent, so pass ``device="cpu"`` to
    run the plain PyTorch paths). On CUDA every member's zone memory is
    page-locked here, once.
    """

    def __init__(
        self,
        array: StripedZoneArray,
        *,
        default_tier: str = CsdTier.JIT,
        pages_per_read: int = 1,
        limits: VerifierLimits = VerifierLimits(),
        max_workers: Optional[int] = None,
        queue_depth: int = 64,
        completion_backlog: int = 1024,
        cache: Optional[CompiledProgramCache] = None,
        prefetch_depth: int = 2,
        io_timeout_s: Optional[float] = None,
        device="cuda",
    ):
        if array.stripe_blocks % pages_per_read:
            raise ValueError(
                f"stripe_blocks {array.stripe_blocks} must be a multiple of "
                f"pages_per_read {pages_per_read} (chunks must tile into pages)"
            )
        self.torch_device = resolve_device(device)
        if self.torch_device.type == "cuda":
            pin_array_memory(array)
        self._lane = _CardLane(self.torch_device)
        self.array = array
        self.default_tier = default_tier
        self.pages_per_read = int(pages_per_read)
        self.limits = limits
        self.queue_depth = queue_depth
        self.completion_backlog = completion_backlog
        self.prefetch_depth = int(prefetch_depth)
        # per-op join patience for chunk reads: a hung member completion
        # surfaces as a diagnostic TimeoutError naming the stuck transfer
        # instead of stranding a worker forever (None = wait indefinitely)
        self.io_timeout_s = io_timeout_s
        # ``max_workers`` is the legacy thread-per-member fan-out knob,
        # accepted for compatibility but no longer sized to the array: reads
        # are ring-driven, compute is ONE dispatcher issuing array-wide
        # batched calls, and combining rides the striping gather pool — the
        # measured useful host parallelism, independent of member count
        self.max_workers = max_workers
        # ONE cache for every tier and batch shape; programs are
        # device-agnostic so sharing (also across schedulers/CSDs, via the
        # ``cache`` argument) maximizes compile reuse
        self.cache = cache if cache is not None else CompiledProgramCache()
        self._pairs: dict[str, QueuePair] = {}
        self._arbiter = WeightedRoundRobinArbiter()
        self._completions: dict[int, Completion] = {}
        self._watched: set[int] = set()   # cmd_ids a sync caller will wait() on
        self._pending: set[int] = set()   # submitted, not yet completed
        self._comp_cond = threading.Condition()
        self._result: Optional[Completion] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self.history: list[ArrayOffloadStats] = []
        self.register_tenant("default")

    # ------------------------------------------------------------ tenants
    def register_tenant(self, tenant: str, *, weight: int = 1,
                        depth: Optional[int] = None) -> QueuePair:
        """Create an SQ/CQ pair for ``tenant`` with a WRR ``weight``."""
        if tenant in self._pairs:
            raise ValueError(f"tenant {tenant!r} already registered")
        pair = QueuePair(
            SubmissionQueue(tenant, depth=depth or self.queue_depth,
                            weight=weight),
            CompletionQueue(tenant, depth=self.completion_backlog),
        )
        self._pairs[tenant] = pair
        self._arbiter.add(pair)
        return pair

    def queue_pair(self, tenant: str = "default") -> QueuePair:
        return self._pairs[tenant]

    # ------------------------------------------------------------- submit
    def submit(
        self,
        program: Program,
        zone_id: int,
        *,
        tenant: str = "default",
        block_off: int = 0,
        n_blocks: Optional[int] = None,
        tier: Optional[str] = None,
        block: bool = False,
        timeout: Optional[float] = None,
        _watch: bool = False,
    ) -> int:
        """Verify and enqueue an offload; returns the command id.

        Verification happens HERE — a rejected program never occupies a queue
        slot, and the SQ carries only admitted commands. A full SQ raises
        :class:`~repro_torch.array.queues.QueueFullError` unless ``block=True``
        (backpressure).
        """
        pair = self._pairs[tenant]
        zone = self.array.zone(zone_id)
        if n_blocks is None:
            n_blocks = zone.write_pointer - block_off
        if block_off % self.pages_per_read:
            raise ValueError(
                f"block_off {block_off} not aligned to read granularity "
                f"{self.pages_per_read}")
        dtype = np.dtype(program.input_dtype)
        page_elems, n_pages = extent_geometry(
            self.array.block_bytes, dtype, n_blocks, self.pages_per_read)
        t_v = time.perf_counter()
        with _trace.span("offload.verify", tenant=tenant, zone=zone_id,
                         program=program.name):
            insns_verified = verify_program(
                program, page_elems=page_elems, n_pages=n_pages,
                limits=self.limits)
            verify_zone_access(
                zone_write_pointer=zone.write_pointer, block_off=block_off,
                n_blocks=n_blocks)
        _registry().histogram("sched.verify_seconds").observe(
            time.perf_counter() - t_v)
        cmd = OffloadCommand(
            program=program, zone_id=zone_id, block_off=block_off,
            n_blocks=n_blocks,
            tier=resolve_tier(tier or self.default_tier, program),
            tenant=tenant, insns_verified=insns_verified,
        )
        # register BEFORE the dispatcher can see the command: _pending lets
        # wait() distinguish in-flight from evicted/unknown, and a watch
        # protects a sync caller's completion from backlog eviction
        with self._comp_cond:
            self._pending.add(cmd.cmd_id)
            if _watch:
                self._watched.add(cmd.cmd_id)
        try:
            pair.sq.submit(cmd, block=block, timeout=timeout)
        except BaseException:
            with self._comp_cond:
                self._pending.discard(cmd.cmd_id)
                self._watched.discard(cmd.cmd_id)
            raise
        self._wake.set()
        return cmd.cmd_id

    # ------------------------------------------------------------ raw I/O
    def submit_io(
        self,
        io_op: str,
        zone_id: int,
        *,
        block_off: int = 0,
        n_blocks: Optional[int] = None,
        data: Optional[np.ndarray] = None,
        tenant: str = "default",
        member: Optional[int] = None,
        block: bool = False,
        timeout: Optional[float] = None,
        on_complete=None,
        _watch: bool = False,
    ) -> int:
        """Enqueue a RAW device I/O command ("read"/"append") on a tenant's
        SQ; returns the command id. The dispatcher forwards it to the array's
        completion ring WITHOUT blocking, so raw I/O (checkpoint traffic)
        overlaps with offload execution while paying its way through the same
        WRR arbitration as offloads. The SQ depth bounds QUEUED commands
        (admission, felt when the dispatcher is busy executing offloads); the
        number of in-flight transfers is bounded by the device's per-zone
        clocks, not the queue — forwarded commands leave the SQ immediately.

        ``member`` targets ONE array member instead of the logical array —
        the rebuild/scrub path: member-local addressing, same tenant SQs,
        same WRR metering against live offload traffic.
        """
        if io_op not in ("read", "append"):
            raise ValueError(f"unknown io_op {io_op!r}")
        pair = self._pairs[tenant]
        if io_op == "read":
            if member is None:
                zone = self.array.zone(zone_id)
            else:
                zone = self.array.devices[member].zone(zone_id)
            if n_blocks is None:
                n_blocks = zone.write_pointer - block_off
            verify_zone_access(
                zone_write_pointer=zone.write_pointer, block_off=block_off,
                n_blocks=n_blocks)
        elif data is None:
            raise ValueError("append command requires data")
        cmd = OffloadCommand(
            program=None, zone_id=zone_id, block_off=block_off,
            n_blocks=n_blocks, tier=None, tenant=tenant,
            io_op=io_op, data=data, member=member, on_complete=on_complete,
        )
        with self._comp_cond:
            self._pending.add(cmd.cmd_id)
            if _watch:
                self._watched.add(cmd.cmd_id)
        try:
            pair.sq.submit(cmd, block=block, timeout=timeout)
        except BaseException:
            with self._comp_cond:
                self._pending.discard(cmd.cmd_id)
                self._watched.discard(cmd.cmd_id)
            raise
        self._wake.set()
        return cmd.cmd_id

    # ----------------------------------------------------------- dispatch
    def dispatch_one(self) -> bool:
        """Arbitrate and launch ONE queued command. Returns False when every
        SQ is empty. Offload commands execute to completion here; raw I/O
        commands are forwarded to the completion ring and retire later (their
        completion lands via the reactor, not this thread)."""
        nxt = self._arbiter.next_command()
        if nxt is None:
            return False
        cmd, pair = nxt
        if _trace.enabled() and cmd.submitted_at:
            # SQ residency as a trace event on the tenant's own track —
            # emitted post-hoc now that the interval is known
            _trace.event_complete(
                "offload.queued", cmd.submitted_at,
                time.monotonic() - cmd.submitted_at,
                track=f"tenant/{cmd.tenant}", tenant=cmd.tenant,
                cmd=cmd.cmd_id)
        if cmd.io_op is not None:
            self._dispatch_io(cmd, pair)
            return True
        try:
            with _trace.span("offload.execute", tenant=cmd.tenant,
                             tier=cmd.tier, zone=cmd.zone_id,
                             program=cmd.program.name):
                value, stats = self._execute(cmd)
            comp = Completion(cmd.cmd_id, cmd.tenant, value=value, stats=stats)
            self.history.append(stats)
            self._publish_stats(stats)
        except Exception as e:  # surfaced via the CQ, never swallowed
            comp = Completion(cmd.cmd_id, cmd.tenant, error=e)
        self._finish(cmd, pair, comp)
        return True

    def _dispatch_io(self, cmd: OffloadCommand, pair: QueuePair) -> None:
        """Forward a raw I/O command to the array's submit path. Never blocks
        on the emulated transfer: the ring retires the completion, and the
        scheduler's completion bookkeeping runs from its done-callback."""
        try:
            target = self.array if cmd.member is None \
                else self.array.devices[cmd.member]
            if cmd.io_op == "append":
                fut = target.submit_append(cmd.zone_id, cmd.data)
            else:
                fut = target.submit_read(cmd.zone_id, cmd.block_off,
                                         cmd.n_blocks)
        except Exception as e:
            self._finish(cmd, pair, Completion(cmd.cmd_id, cmd.tenant, error=e))
            return
        fut.tenant = cmd.tenant    # stuck-op diagnostics name the owner
        fut.add_done_callback(lambda f: self._finish(
            cmd, pair,
            Completion(cmd.cmd_id, cmd.tenant,
                       value=None if f.error is not None else f.value,
                       error=f.error)))

    @staticmethod
    def _publish_stats(stats: ArrayOffloadStats) -> None:
        """Fold one command's ArrayOffloadStats into the global registry, so
        ``metrics.registry().snapshot()`` shows the rolling offload picture
        (commands, read/compute/overlap seconds, the latest overlap ratio)
        next to the cache and gather-pool series."""
        reg = _registry()
        reg.counter("offload.commands").inc()
        reg.counter("offload.dispatches").inc(stats.n_dispatches)
        reg.histogram("offload.exec_seconds").observe(stats.exec_seconds)
        reg.histogram("offload.read_seconds").observe(stats.read_seconds)
        reg.histogram("offload.read_wait_seconds").observe(
            stats.read_wait_seconds)
        reg.histogram("offload.overlap_seconds").observe(stats.overlap_seconds)
        reg.gauge("offload.overlap_ratio").set(stats.overlap_ratio)

    def _account_tenant(self, cmd: OffloadCommand, comp: Completion) -> None:
        """Per-tenant QoS accounting at completion time (offloads AND raw
        I/O ride through here): bytes moved, ops, end-to-end command latency
        (SQ entry → completion, the SLO the alert rules watch), errors, and
        degraded-read counts. Tenant names are a bounded set (queues.py), so
        the series live on the global registry."""
        reg = _registry()
        t = cmd.tenant
        reg.counter(f"tenant.{t}.ops").inc()
        if comp.error is not None:
            reg.counter(f"tenant.{t}.errors").inc()
        if cmd.io_op == "append" and cmd.data is not None:
            nbytes = int(np.asarray(cmd.data).nbytes)
        else:
            nbytes = (cmd.n_blocks or 0) * self.array.block_bytes
        if nbytes:
            reg.counter(f"tenant.{t}.bytes").inc(nbytes)
        if cmd.submitted_at:
            reg.histogram(
                f"tenant.{t}.offload_latency_seconds").observe(
                    time.monotonic() - cmd.submitted_at)
        degraded = getattr(comp.stats, "degraded_reads", 0)
        if degraded:
            reg.counter(f"tenant.{t}.degraded_reads").inc(degraded)
        if comp.stats is not None:
            comp.stats.tenant_totals = self._tenant_snapshot(t)

    def _tenant_snapshot(self, tenant: str) -> dict:
        """One tenant's cumulative accounting, read straight off the series
        handles (no full registry snapshot on the completion path)."""
        reg = _registry()
        pfx = f"tenant.{tenant}."
        lat = reg.histogram(pfx + "offload_latency_seconds")
        return {
            "tenant": tenant,
            "bytes": reg.counter(pfx + "bytes").value,
            "ops": reg.counter(pfx + "ops").value,
            "errors": reg.counter(pfx + "errors").value,
            "degraded_reads": reg.counter(pfx + "degraded_reads").value,
            "p50_s": lat.percentile(50),
            "p99_s": lat.percentile(99),
        }

    def tenant_stats(self) -> dict[str, dict]:
        """``{tenant: {bytes, ops, errors, degraded_reads, p50_s, p99_s}}``
        for every registered tenant — the QoS report the ROADMAP's
        per-tenant accounting item asks for (``zcsd-top`` renders it live)."""
        return {t: self._tenant_snapshot(t) for t in self._pairs}

    def _finish(self, cmd: OffloadCommand, pair: QueuePair,
                comp: Completion) -> None:
        """Completion bookkeeping shared by the synchronous offload path and
        the ring-retired raw-I/O path (any thread may run this)."""
        self._account_tenant(cmd, comp)
        with self._comp_cond:
            watched = cmd.cmd_id in self._watched
        # when the payload has a dedicated consumer — a sync caller's wait()
        # (watched) or an on_complete hook — every OTHER completion surface
        # gets a payload-free record (stats/errors stay observable), so
        # neither the CQ ring nor the wait() rendezvous pins up to `depth`
        # dead result buffers (e.g. a queue-routed restore's leaf extents)
        stripped = Completion(cmd.cmd_id, cmd.tenant, value=None,
                              stats=comp.stats, error=comp.error) \
            if (watched or cmd.on_complete is not None) else comp
        pair.cq.push(stripped)
        stored = comp if watched else stripped
        with self._comp_cond:
            self._completions[cmd.cmd_id] = stored
            self._pending.discard(cmd.cmd_id)
            # bound the wait() rendezvous: consumers that read the CQ directly
            # never pop here, so evict oldest-first past the backlog limit —
            # but never a completion a sync caller has reserved with a watch
            while len(self._completions) > self.completion_backlog:
                victim = next((k for k in self._completions
                               if k not in self._watched), None)
                if victim is None:
                    break
                self._completions.pop(victim)
            if cmd.program is not None:
                # raw I/O must not clobber the part-i last-result register
                self._result = comp
            self._comp_cond.notify_all()
        if cmd.on_complete is not None:
            try:
                cmd.on_complete(comp)
            except Exception:
                pass  # a consumer hook must not kill the dispatcher/reactor

    def drain(self) -> int:
        """Dispatch until every submission queue is empty (synchronous pump)."""
        n = 0
        while self.dispatch_one():
            n += 1
        return n

    def wait(self, cmd_id: int, *, timeout: Optional[float] = None) -> Completion:
        """Block until ``cmd_id`` completes (requires a running dispatcher or
        a concurrent ``drain``)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._comp_cond:
            while cmd_id not in self._completions:
                if cmd_id not in self._pending:
                    raise LookupError(
                        f"command {cmd_id} has no pending completion (already "
                        f"waited, evicted past completion_backlog, or unknown)")
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"command {cmd_id} still pending")
                self._comp_cond.wait(timeout=remaining)
            self._watched.discard(cmd_id)
            return self._completions.pop(cmd_id)

    def start(self) -> None:
        """Run the dispatcher on a background thread (async mode — the
        paper's stated future extension, at array scope)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if not self.dispatch_one():
                    self._wake.wait(timeout=0.01)
                    self._wake.clear()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="offload-dispatcher")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._wake.set()
        self._thread.join()
        self._thread = None

    def close(self) -> None:
        """Stop the dispatcher (if running). The staged pipeline owns no
        worker pool — reads ride the completion ring and combining the
        shared gather pool — so there is nothing else to release. The
        scheduler is unusable afterwards; the array is not."""
        self.stop()

    def __enter__(self) -> "OffloadScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------- NvmCsd-compatible part-i
    def _run_sync(self, program: Program, zone_id: int, *,
                  block_off: int = 0, n_blocks: Optional[int] = None,
                  tier: Optional[str] = None,
                  tenant: str = "default") -> Completion:
        """Submit, wait, and return THIS command's completion (not the shared
        last-result register, which another tenant may overwrite)."""
        cmd_id = self.submit(program, zone_id, tenant=tenant,
                             block_off=block_off, n_blocks=n_blocks, tier=tier,
                             _watch=True)
        if self._thread is None:
            self.drain()
        # unbounded wait is safe: either a dispatcher thread is running, or
        # drain() returned with every SQ empty — meaning our command was
        # popped (possibly by a concurrent caller's drain) and its completion
        # is forthcoming
        comp = self.wait(cmd_id)
        if comp.error is not None:
            raise comp.error
        return comp

    def nvm_cmd_bpf_run(self, program: Program, zone_id: int, *,
                        block_off: int = 0, n_blocks: Optional[int] = None,
                        tier: Optional[str] = None,
                        tenant: str = "default") -> ArrayOffloadStats:
        """Synchronous verified offload over the whole array (the degenerate
        single-command path through the queue machinery)."""
        return self._run_sync(program, zone_id, block_off=block_off,
                              n_blocks=n_blocks, tier=tier, tenant=tenant).stats

    def nvm_cmd_bpf_result(self) -> object:
        if self._result is None or self._result.error is not None:
            raise RuntimeError("no offload result available")
        return self._result.value

    def run_and_fetch(self, program: Program, zone_id: int, **kw):
        comp = self._run_sync(program, zone_id, **kw)
        return comp.value, comp.stats

    # ---------------------------------------------------------- execution
    def _execute(self, cmd: OffloadCommand) -> tuple[object, ArrayOffloadStats]:
        """Three-stage offload pipeline.

        1. **read stage** — every member transfer the plan needs goes in
           flight on the completion ring UP FRONT: coalesced chunk-group
           reads per member, tail-chunk reads, xor survivor reconstructions.
           No thread parks per transfer; in-flight depth is bounded by the
           emulated devices.
        2. **compute stage** — ONE dispatcher consumes staged groups in
           logical order and issues ONE array-wide batched compiled call per
           group over the chunks of ALL members (total chunk count is a
           property of the logical extent, so the dispatch shape — and the
           host work — is constant across array widths). Tail, degraded and
           fallback chunks ride the same staged bytes through the plain
           per-chunk executables.
        3. **combine stage** — the program-aware combiner folds per-chunk
           partials in logical stripe order ON THE GATHER POOL as results
           land, off the straggler's critical path; the stage span covers
           only the final rendezvous.
        """
        program, zone_id, tier = cmd.program, cmd.zone_id, cmd.tier
        array = self.array
        reg = _registry()
        t_p = time.perf_counter()
        with _trace.span("offload.plan"):
            try:
                chunks = array.chunks(zone_id, cmd.block_off, cmd.n_blocks)
            except (ZNSError, TransientIOError) as e:
                # the PR 2 clean-error contract: callers handle degraded/
                # failed offloads via ArrayOffloadError, whether one raid0
                # member died or the loss defeated the redundancy mode
                raise ArrayOffloadError(
                    f"offload failed: zone {zone_id} unrecoverable under "
                    f"{array.redundancy}: {e}"
                ) from e
        reg.histogram("sched.plan_seconds").observe(time.perf_counter() - t_p)
        if any(c.degraded for c in chunks):
            array.note_degraded_serving(zone_id)
        n_members = len({c.device for c in chunks})
        pos_of = {c.index: p for p, c in enumerate(chunks)}

        t0 = time.perf_counter()
        t_r = time.perf_counter()
        with _trace.span("offload.stage.read", devices=n_members,
                         chunks=len(chunks)):
            staged = self._submit_stage_reads(zone_id, chunks, program, tier)
        reg.histogram("sched.stage.read_seconds").observe(
            time.perf_counter() - t_r)

        agg = _StageAgg({})
        combiner = _StagedCombiner(program, len(chunks))
        t_x = time.perf_counter()
        with _trace.span("offload.stage.compute", groups=len(staged.groups),
                         chunks=len(chunks)):
            self._compute_stage(cmd, staged, pos_of, agg, combiner)
        reg.histogram("sched.stage.compute_seconds").observe(
            time.perf_counter() - t_x)

        t_c = time.perf_counter()
        with _trace.span("offload.stage.combine"):
            value = combiner.result()
        agg.combine_s = combiner.fold_seconds
        agg.fold_events()           # every group has landed: events are done
        reg.histogram("sched.stage.combine_seconds").observe(
            time.perf_counter() - t_c)
        # keep exec and JIT time disjoint, as NvmCsd reports them (compiles
        # happen inside the pipeline wall time on cache misses)
        exec_seconds = max(time.perf_counter() - t0 - agg.compile_s, 0.0)

        if isinstance(value, tuple):
            bytes_returned = np.asarray(value[0]).nbytes + 8
        else:
            bytes_returned = np.asarray(value).nbytes
        stats = ArrayOffloadStats(
            program=program.name, tier=tier, zone_id=zone_id,
            pages=cmd.n_blocks // self.pages_per_read,
            insns_verified=cmd.insns_verified,
            insns_executed=agg.insns,
            bytes_read=cmd.n_blocks * array.block_bytes,
            bytes_returned=bytes_returned,
            jit_seconds=agg.compile_s, exec_seconds=exec_seconds,
            read_seconds=agg.read_s, compute_seconds=agg.compute_s,
            h2d_seconds=agg.h2d_s,
            read_wait_seconds=agg.read_wait_s, stage_seconds=agg.stage_s,
            combine_seconds=agg.combine_s,
            overlap_seconds=max(agg.read_s - agg.read_wait_s, 0.0),
            cache_hits=agg.hits, cache_misses=agg.misses,
            n_devices=n_members, n_chunks=len(chunks),
            batched_chunks=agg.batched, n_dispatches=agg.dispatches,
            degraded_reads=agg.degraded,
            tenant=cmd.tenant,
        )
        return value, stats

    # ----------------------------------------------------------- read stage
    def _submit_stage_reads(self, zone_id: int, chunks: list[StripeChunk],
                            program: Program, tier: str) -> "_StagedReads":
        """READ stage: classify the planned chunks and put every member
        transfer in flight before any compute runs.

        Full-size chunks (jit/kernel tiers, more than one) form the batch
        groups: consecutive logical chunks, bucketed to a power-of-two batch
        width, each group's member shares coalesced into maximal contiguous
        runs — ONE ring read per run (raid0/xor coalesce whole groups;
        raid1's round-robin replica assignment is member-locally
        discontiguous and degrades to per-chunk runs, all still in flight up
        front). Tail chunks and xor reconstructions submit alongside. A
        member that fails AT SUBMISSION parks its chunks on the fallback
        list for the degraded re-serve (raid0 raises — the PR 2 clean-error
        contract). Each run's rows are the next contiguous block of its
        group's batch, so the run lands with one copy."""
        array = self.array
        stripe = array.stripe_blocks
        dtype = np.dtype(program.input_dtype)
        direct = [c for c in chunks if not c.reconstruct]
        recon = [c for c in chunks if c.reconstruct]
        full = [c for c in direct if c.n_blocks == stripe]
        # a single full chunk reuses the plain single-chunk executable
        # (shared with NvmCsd) instead of compiling a batch-of-1 variant
        if tier in (CsdTier.JIT, CsdTier.KERNEL) and len(full) > 1:
            rest = [c for c in direct if c.n_blocks != stripe]
        else:
            full, rest = [], direct
        staged = _StagedReads()
        if full:
            m = len(full)
            # Split into pipeline groups, then bucket the group size to a
            # power of two and pad the tail group, so compiles stay
            # O(#programs x log(total chunks)) instead of one per distinct
            # extent size; pad-row outputs are discarded at dispatch. Floor
            # of 2: a batch-of-1 variant would duplicate the plain
            # single-chunk executable at the cost of an extra build.
            n_groups = max(min(self.prefetch_depth, m), 1)
            staged.m_b = max(1 << (-(-m // n_groups) - 1).bit_length(), 2)
            for i in range(0, m, staged.m_b):
                grp_chunks = full[i:i + staged.m_b]
                runs = []
                slot = 0
                for dev_idx, items in coalesce_member_runs(grp_chunks,
                                                           stripe):
                    n_blocks = sum(c.n_blocks for _, c in items)
                    try:
                        fut = array.devices[dev_idx].submit_read(
                            zone_id, items[0][1].local_off, n_blocks,
                            dtype=dtype)
                    except (ZNSError, TransientIOError) as e:
                        self._member_failed(dev_idx, zone_id, e)
                        staged.fallback.extend(c for _, c in items)
                        continue
                    rows = [(slot + j, c) for j, (_, c) in enumerate(items)]
                    slot += len(rows)
                    runs.append(_MemberRun(dev_idx, rows, fut))
                staged.groups.append(_StageGroup(grp_chunks, runs))
        for c in rest:
            try:
                fut = array.devices[c.device].submit_read(
                    zone_id, c.local_off, c.n_blocks)
            except (ZNSError, TransientIOError) as e:
                self._member_failed(c.device, zone_id, e)
                staged.fallback.append(c)
                continue
            staged.rest.append((c, fut))
        for c in recon:
            try:
                staged.recon.append(
                    (c, array.submit_read(zone_id, c.logical_off,
                                          c.n_blocks)))
            except (ZNSError, TransientIOError) as e:
                raise ArrayOffloadError(
                    f"offload failed: chunk {c.index} of zone {zone_id} is "
                    f"unrecoverable under {array.redundancy}: {e}"
                ) from e
        return staged

    # -------------------------------------------------------- compute stage
    def _compute_stage(self, cmd: OffloadCommand, staged: "_StagedReads",
                       pos_of: dict[int, int], agg: "_StageAgg",
                       combiner: "_StagedCombiner") -> None:
        """COMPUTE stage: one dispatcher thread drains the staged reads in
        logical order and issues one array-wide batched compiled call per
        group; every partial is handed to the combiner the moment it exists,
        so combining overlaps the next group's read wait and dispatch.

        A ``TransientIOError`` surfacing on one member's group read does NOT
        poison the batch: the surviving runs still stage and dispatch
        together (the dead member's rows stay unstaged and their outputs
        are discarded), and the failed member's chunks re-serve individually
        through the array's degraded read — raid1 mirror redirect / xor
        reconstruction, the exact observable behavior of the pre-staged
        per-worker fallback.

        Every executable is prepared for, and every per-chunk extent runs
        on, the scheduler's ``torch_device``; a group's staging and launch
        go through :class:`_CardLane`."""
        program, zone_id, tier = cmd.program, cmd.zone_id, cmd.tier
        array = self.array
        reg = _registry()
        stripe = array.stripe_blocks

        def serve_degraded(c: StripeChunk, fut=None) -> None:
            with _trace.span("stage.serve_chunk", chunk=c.index,
                             degraded=True):
                self._run_chunk_degraded(zone_id, c, program, tier, agg,
                                         fut=fut)
            combiner.feed({pos_of[c.index]: agg.vals.pop(c.index)})

        if staged.groups:
            m_b = staged.m_b
            dtype = np.dtype(program.input_dtype)
            page_elems, chunk_pages = extent_geometry(
                array.block_bytes, dtype, stripe, self.pages_per_read)
            chunk_bytes = stripe * array.block_bytes
            tdtype = _TORCH_DTYPE[dtype]
            dev = self.torch_device
            # the keys name the device: CPU and CUDA executables never collide
            if tier == CsdTier.KERNEL:
                from repro_torch.kernels.zone_filter import ops as zf_ops
                key = ("kernel_batched", program, m_b, chunk_pages,
                       page_elems, str(dev))
                builder = lambda: zf_ops.kernel_program_batched(
                    program, m_b, chunk_pages, page_elems, device=dev)
            else:
                key = ("jit_batched", program, m_b, chunk_pages, page_elems,
                       str(dev))
                builder = lambda: jit_program_batched(
                    program, m_b, chunk_pages, page_elems, device=dev)
            jp, compile_s, hit = self.cache.get_or_build(key, builder)
            agg.compile_s += compile_s
            agg.hits += int(hit)
            agg.misses += int(not hit)
        for grp in staged.groups:
            # read_wait = wall time the dispatcher BLOCKED on this group's
            # ring completions (near zero when earlier groups' dispatch
            # covered the transfers) — the number that grows if the pipeline
            # serializes on I/O
            served, ready = [], []
            t_w = time.perf_counter()
            with _trace.span("stage.read_wait", chunks=len(grp.chunks)):
                for run in grp.runs:
                    try:
                        raw = run.fut.result(self.io_timeout_s)
                    except (ZNSError, TransientIOError) as e:
                        self._member_failed(run.device, zone_id, e)
                        staged.fallback.extend(c for _, c in run.items)
                        continue
                    agg.read_s += run.fut.service_seconds
                    served.extend(run.items)
                    ready.append((run, raw))
            dt = time.perf_counter() - t_w
            agg.read_wait_s += dt
            reg.histogram("sched.stage.read_wait_seconds").observe(dt)
            if not served:
                continue
            t_s = time.perf_counter()
            with _trace.span("stage.staging", chunks=len(served)):
                batch, copied = self._lane.stage(array, ready, m_b,
                                                 chunk_bytes, agg)
                pages = batch.view(tdtype).reshape(m_b, chunk_pages,
                                                   page_elems)
            dt = time.perf_counter() - t_s
            agg.stage_s += dt
            reg.histogram("sched.stage.staging_seconds").observe(dt)
            t_d = time.perf_counter()
            with _trace.span("stage.dispatch", chunks=len(served)):
                out, done = self._lane.launch(jp, pages, copied, agg)
            dt = time.perf_counter() - t_d
            if done is None:        # the CPU ran it inline
                agg.compute_s += dt
            agg.dispatches += 1
            reg.histogram("sched.stage.dispatch_seconds").observe(dt)
            agg.batched += len(served)
            agg.degraded += sum(1 for _, c in served if c.degraded)
            # Land the batch output OFF the dispatcher: waiting for the card
            # here would serialize group k's compute ahead of group k+1's
            # read wait and dispatch — the pool thread waits for the launch's
            # event instead, copies the result to the host, then feeds the
            # combiner its rows in one go.
            rows = [(row, pos_of[c.index]) for row, c in served]

            def land(out=out, done=done, rows=rows):
                try:
                    with _trace.span("stage.materialize", rows=len(rows)):
                        if done is not None:
                            done.synchronize()
                        host = jp.to_host(out)
                        if isinstance(host, tuple):
                            bufs, ns = host
                            vals = {pos: (bufs[row], ns[row])
                                    for row, pos in rows}
                        else:
                            vals = {pos: host[row] for row, pos in rows}
                    combiner.feed(vals)
                except BaseException as e:
                    combiner.fail(e)

            _gather_executor().submit(land)
        if staged.groups:
            agg.insns += program.n_insns * agg.batched * (
                stripe // self.pages_per_read)

        for c, fut in staged.rest:
            t_w = time.perf_counter()
            try:
                flat = np.asarray(fut.result(self.io_timeout_s))
            except (ZNSError, TransientIOError) as e:
                agg.read_wait_s += time.perf_counter() - t_w
                self._member_failed(c.device, zone_id, e)
                serve_degraded(c)
                continue
            agg.read_wait_s += time.perf_counter() - t_w
            agg.read_s += fut.service_seconds
            with _trace.span("stage.serve_chunk", chunk=c.index):
                src = _ExtentSource(array.block_bytes, c.local_off, flat)
                result = execute_extent(
                    src, program, zone_id, c.local_off, c.n_blocks,
                    tier=tier, pages_per_read=self.pages_per_read,
                    cache=self.cache, prefetch_depth=0,
                    torch_device=self.torch_device,
                )
            if c.degraded:
                agg.degraded += 1
            agg.fold_result(result)
            combiner.feed({pos_of[c.index]: result.value})
        for c, fut in staged.recon:
            serve_degraded(c, fut=fut)
        for c in staged.fallback:
            serve_degraded(c)

    def _member_failed(self, dev_idx: int, zone_id: int,
                   e: Exception) -> None:
        """Raise the PR 2 clean degradation error when the array has no
        redundancy to absorb the member failure; otherwise return and let
        the caller reconstruct."""
        if self.array.redundancy == "raid0":
            raise ArrayOffloadError(
                f"offload degraded: member device {dev_idx} failed on zone "
                f"{zone_id}: {e}"
            ) from e

    def _run_chunk_degraded(self, zone_id: int, c: StripeChunk,
                            program: Program, tier: str,
                            agg: "_StageAgg", *,
                            fut=None) -> None:
        """Execute one chunk whose member cannot serve it: rebuild the bytes
        through the array's degraded read (raid1 mirror redirect / xor
        survivor reconstruction, riding the completion ring) and run the
        SAME execution tier over the host buffer — bit-identical results by
        construction. Pass a pre-submitted ``fut`` to overlap many chunks'
        reconstruction transfers (the planned-degraded fan-out does)."""
        t_w = time.perf_counter()
        try:
            if fut is None:
                fut = self.array.submit_read(zone_id, c.logical_off,
                                             c.n_blocks)
            flat = np.asarray(fut.result(self.io_timeout_s))
        except (ZNSError, TransientIOError) as e:
            raise ArrayOffloadError(
                f"offload failed: chunk {c.index} of zone {zone_id} is "
                f"unrecoverable under {self.array.redundancy}: {e}"
            ) from e
        finally:
            agg.read_wait_s += time.perf_counter() - t_w
        src = _ExtentSource(self.array.block_bytes, c.local_off, flat)
        result = execute_extent(
            src, program, zone_id, c.local_off, c.n_blocks,
            tier=tier, pages_per_read=self.pages_per_read,
            cache=self.cache, prefetch_depth=0,
            torch_device=self.torch_device,
        )
        agg.vals[c.index] = result.value
        agg.fold_result(result)
        agg.read_s += fut.service_seconds
        agg.degraded += 1

    # ----------------------------------------------------------- combiner
    def _combine(self, program: Program, ordered: list[object]) -> object:
        """Re-reduce per-chunk results in logical stripe order — the
        scatter-gather step, as one inline fold. Semantics match
        :func:`repro_torch.core.vm.run_oracle` over the concatenated logical
        stream; the staged pipeline streams the same fold incrementally
        through :class:`_StagedCombiner`."""
        comb = _StagedCombiner(program, len(ordered))
        comb.feed(dict(enumerate(ordered)), inline=True)
        return comb.result()
