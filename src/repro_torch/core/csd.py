"""The ZCSD device: zoned storage + verified offload execution.

Mirrors the paper's two-part ``NvmCsd`` API (Listing 1):

  part-i  (app <-> ZCSD): :meth:`NvmCsd.nvm_cmd_bpf_run` submits a program and
          executes it synchronously; :meth:`NvmCsd.nvm_cmd_bpf_result` fetches
          the result. :meth:`NvmCsd.nvm_cmd_bpf_run_async` is the asynchronous
          extension the paper lists as future work.
  part-ii (program <-> device hooks): :meth:`bpf_read` (bounds-checked page
          read), :meth:`bpf_return_data`, :meth:`bpf_get_lba_size`,
          :meth:`bpf_get_mem_info` — the environment the interpreter tier
          executes against.

The device keeps the paper's per-offload statistics: runtime, number of
instructions executed, JIT time, and the amount of data movement saved.

Workflow lifecycle (paper Figure 1): (1) app calls the API with a program;
(2,3) device reads the necessary blocks from the ZNS zone; (4,5) program is
verified and JITed; (6) only the (reduced) result returns to the app.
"""
from __future__ import annotations

import concurrent.futures
import itertools
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch._device import (host_tensor, host_to_device, register_mapped,
                                resolve_device)

from repro_torch.core.cache import CompiledProgramCache
from repro_torch.core.prefetch import RingReader
from repro_torch.telemetry import trace as _trace
from repro_torch.core.programs import Program
from repro_torch.core.verifier import VerifierLimits, verify_program, verify_zone_access
from repro_torch.core.vm import (
    _TORCH_DTYPE,
    OffloadResult,
    interpret_program,
    jit_program,
    run_oracle,
)
from repro_torch.zns.device import ZonedDevice

__all__ = ["NvmCsd", "OffloadStats", "CsdTier", "extent_geometry",
           "execute_extent", "resolve_tier", "pin_zone_memory",
           "unpin_zone_memory", "pin_array_memory", "stage_extent",
           "CopyCounter", "h2d", "in_place", "reads_in_place",
           "IN_PLACE_MAX_BYTES"]

TIERS = ("interp", "jit", "kernel")

# ``cmd`` ids of traced commands, unique across every NvmCsd and thread of
# the process (``next`` on a count is atomic under the interpreter lock)
_cmd_ids = itertools.count(1)


def resolve_tier(tier: str, program: Program) -> str:
    """The tier that will actually execute ``program``: kernel-tier requests
    for non-kernelizable programs fall back to the jit tier, and the
    stats/history must say so rather than mis-attributing JIT timings."""
    if tier == CsdTier.KERNEL:
        from repro_torch.kernels.zone_filter import ops as zf_ops
        if not zf_ops.kernelizable(program):
            return CsdTier.JIT
    return tier


# ---------------------------------------------------------------------------
# the zone-to-card seam
# ---------------------------------------------------------------------------

class CopyCounter:
    """Host-to-card copies made by the offload paths: ``copies`` and
    ``bytes``. Exact when many threads add at once (several CSDs, the
    dispatchers of several array schedulers)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.copies = 0
        self.bytes = 0

    def add(self, nbytes: int) -> None:
        with self._lock:
            self.copies += 1
            self.bytes += int(nbytes)

    def snapshot(self) -> tuple[int, int]:
        """``(copies, bytes)``, read together."""
        with self._lock:
            return self.copies, self.bytes


# every host-to-card copy of zone bytes, wherever the offload path makes it
h2d = CopyCounter()
# every extent a kernel read in place from mapped zone memory, with no copy
in_place = CopyCounter()

# The largest extent a kernel-tier command reads in place; a larger one is
# copied to the card first. Where the two paths' latencies cross on an H100
# (tools/stage_sweep.py, PERF.md section 6), rounded down to a power of two,
# on the machine where they cross soonest: whole 64 MiB commands read
# across the link at 25-43 GB/s in place from one machine to the next, and
# at 42-46 GB/s copied, so the crossover lay between 1 and 2 MiB on one
# machine and between 4 and 8 MiB on another.
IN_PLACE_MAX_BYTES = 1 << 20

_pinned: "weakref.WeakKeyDictionary[ZonedDevice, weakref.finalize]" = \
    weakref.WeakKeyDictionary()
_mapped: "weakref.WeakKeyDictionary[ZonedDevice, _CardAlias]" = \
    weakref.WeakKeyDictionary()
_pin_lock = threading.Lock()


class _CardAlias:
    """A zone buffer as the card addresses it: ``alias``, a uint8 tensor
    over the whole buffer at its mapped address (no copy of it exists).
    The tensor belongs to one device, ``card`` (an ordinal): the one the
    runtime reports for the memory, current when it was registered."""

    def __init__(self, buf: np.ndarray, alias: torch.Tensor):
        self.base = buf.ctypes.data
        self.nbytes = buf.nbytes
        self.card = alias.get_device()
        self._typed = {torch.uint8: alias}      # the alias in each zone type

    def extent(self, pages: np.ndarray) -> torch.Tensor:
        """``pages``, a view of the buffer, as the same bytes on the card."""
        off = pages.ctypes.data - self.base
        if off < 0 or off + pages.nbytes > self.nbytes:
            raise ValueError("extent outside the mapped zone memory")
        dtype = _TORCH_DTYPE[pages.dtype]
        typed = self._typed.get(dtype)
        if typed is None:
            typed = self._typed[dtype] = self._typed[torch.uint8].view(dtype)
        size = pages.itemsize
        return typed.as_strided(pages.shape, [s // size for s in pages.strides],
                                off // size)


class _CudaArray:
    """``nbytes`` at ``address`` on the card, in the form ``torch.as_tensor``
    takes (the CUDA array interface); ``owner`` keeps the memory alive."""

    def __init__(self, address: int, nbytes: int, owner):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (address, False),
            "strides": None, "version": 2}
        self._owner = owner


def _unpin(buf: np.ndarray) -> None:
    torch.cuda.cudart().cudaHostUnregister(buf.ctypes.data)


def pin_zone_memory(device: ZonedDevice) -> None:
    """Page-lock ``device``'s whole backing buffer once and map it into the
    card's address space (``cudaHostRegisterMapped``), so that a kernel
    reads a small extent in place and a large one reaches the card in a
    single DMA with no staging copy on the host. Where the runtime will not
    map it (file-backed memory, for one), it is page-locked only and every
    extent is copied. Unregistered when the device is collected (the
    finalizer holds the buffer until then), or by :func:`unpin_zone_memory`.
    Idempotent."""
    with _pin_lock:
        if device in _pinned:
            return
        buf = device._buf            # the zones' backing bytes
        card = register_mapped(buf.ctypes.data, buf.nbytes)
        if card is None:
            err = torch.cuda.cudart().cudaHostRegister(buf.ctypes.data, buf.nbytes, 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of the zone memory "
                                   f"({buf.nbytes} bytes) failed: cudaError {int(err)}")
        else:
            _mapped[device] = _CardAlias(
                buf, torch.as_tensor(_CudaArray(card, buf.nbytes, buf)))
        _pinned[device] = weakref.finalize(device, _unpin, buf)


def unpin_zone_memory(device: ZonedDevice) -> None:
    """Drop ``device``'s alias on the card and unregister its buffer now
    rather than when it is collected. No copy from it, and no kernel
    reading it, may be in flight. Idempotent."""
    with _pin_lock:
        _mapped.pop(device, None)
        fin = _pinned.pop(device, None)
    if fin is not None:
        fin()


def pin_array_memory(array) -> None:
    """Page-lock each member of a striped array once, as :class:`NvmCsd`
    does for its one device: the array scheduler copies member reads (views
    of these buffers) straight to the card."""
    for member in array.devices:
        pin_zone_memory(member)


def reads_in_place(card: Optional[int], tier: str, zoned: bool,
                   mapped_on: Optional[int], nbytes: int) -> bool:
    """Whether an extent of ``nbytes`` is read where it lies, in mapped zone
    memory, rather than copied to the card first: only by the kernel tier
    (the jit tier's many passes would each cross the link) on a CUDA device
    (``card``, its ordinal; None off CUDA), from a :class:`ZonedDevice`
    (``zoned``; the array scheduler's chunk sources are not) whose buffer
    is mapped with its alias on that same device (``mapped_on``, the
    alias's ordinal; None where the buffer is not mapped), and only up to
    :data:`IN_PLACE_MAX_BYTES`, beyond which the copy engine is faster."""
    return (card is not None and tier == CsdTier.KERNEL and zoned
            and mapped_on == card and nbytes <= IN_PLACE_MAX_BYTES)


def _card(torch_device: torch.device) -> Optional[int]:
    """The ordinal of the CUDA device a command on ``torch_device`` runs on;
    None off CUDA."""
    if torch_device.type != "cuda":
        return None
    index = torch_device.index
    return torch.cuda.current_device() if index is None else index


def stage_extent(device, pages: np.ndarray, torch_device: torch.device, *,
                 read_in_place: bool = False) -> tuple[torch.Tensor, float]:
    """Move a zone extent to ``torch_device``: ``(tensor, seconds)``.

    On CUDA with ``read_in_place`` (:func:`reads_in_place`), the tensor is the
    extent's slice of the card's alias of the mapped zone memory: nothing
    is copied, allocated or waited for, and the read counts in
    :data:`in_place`. Otherwise it is one blocking host-to-card copy,
    counted in :data:`h2d`.
    The extent of a :class:`ZonedDevice` is a read-only view of its buffer,
    page-locked here once, so the copy is a single DMA from zone memory.
    Any other source (a chunk the array scheduler re-read or reconstructed
    into host memory, ``repro_torch.array.scheduler._ExtentSource``) has no
    buffer of its own to page-lock: its pages go through a page-locked
    bounce buffer from PyTorch's caching host allocator, which keeps freed
    blocks for reuse, so a steady stream of chunks allocates nothing. On
    the CPU the tensor aliases the view (no copy, nothing counted)."""
    if torch_device.type != "cuda":
        return host_to_device(pages, torch_device), 0.0
    t0 = time.perf_counter()
    if read_in_place:
        out = _mapped[device].extent(pages)
        seconds = time.perf_counter() - t0
        in_place.add(pages.nbytes)
        return out, seconds
    src = host_tensor(pages)
    if isinstance(device, ZonedDevice):
        pin_zone_memory(device)
    else:
        src = src.pin_memory()                    # the bounce
    out = src.to(torch_device)                    # blocking: the DMA is done
    seconds = time.perf_counter() - t0
    h2d.add(pages.nbytes)
    return out, seconds


def extent_geometry(
    block_bytes: int, dtype: np.dtype, n_blocks: int, pages_per_read: int
) -> tuple[int, int]:
    """Page geometry of a zone extent: (elements per page, number of pages).

    Raises ValueError when the extent does not tile into whole pages — the
    alignment contract every execution tier relies on.
    """
    page_elems = block_bytes * pages_per_read // dtype.itemsize
    if block_bytes * pages_per_read % dtype.itemsize:
        raise ValueError("block size not a multiple of element size")
    if n_blocks % pages_per_read:
        raise ValueError(
            f"extent of {n_blocks} blocks not a multiple of read granularity "
            f"{pages_per_read}"
        )
    return page_elems, n_blocks // pages_per_read


def execute_extent(
    device: ZonedDevice,
    program: Program,
    zone_id: int,
    block_off: int,
    n_blocks: int,
    *,
    tier: str,
    pages_per_read: int = 1,
    cache: Optional[CompiledProgramCache] = None,
    prefetch_depth: int = 2,
    torch_device="cuda",
) -> OffloadResult:
    """Execute an (already verified) program over one zone extent on one
    device, on the requested tier. The single-device execution engine shared
    by :class:`NvmCsd` and the array scheduler (which calls it per stripe
    chunk when the batched path does not apply).

    The jit and kernel tiers compute on ``torch_device``. ``read_extent``
    hands out a typed view of the page-locked device buffer. On the kernel
    tier a small extent of a mapped :class:`ZonedDevice`
    (:func:`reads_in_place`) is read by the kernel where it lies; on CUDA
    the kernel tier's result is written to a mapped result slot, so a
    command that reads in place waits for the card once. Any other extent
    reaches the card with one copy
    (:func:`stage_extent`: one DMA from the page-locked buffer; a
    ``device`` that is not a :class:`ZonedDevice`, such as the array
    scheduler's in-memory chunk source, goes through a page-locked bounce
    buffer). Either step is timed inside ``exec_seconds`` and reported as
    ``h2d_seconds``. ``result.compile_seconds`` is non-zero only when this
    call prepared a fresh executable (miss in ``cache``).
    """
    # traced, each step of the jit and kernel tiers is a span that ends as
    # the next begins
    traced = _trace._enabled
    if traced:
        t = time.monotonic()
    tier = resolve_tier(tier, program)   # kernel -> jit for non-kernelizable
    dtype = np.dtype(program.input_dtype)
    page_elems, n_pages = extent_geometry(
        device.block_bytes, dtype, n_blocks, pages_per_read)
    insns_bound = program.n_insns * n_pages
    if cache is None:
        cache = CompiledProgramCache(capacity=4)  # private one-shot cache

    if tier == CsdTier.INTERP:
        def read_page(p: int) -> np.ndarray:
            return device.read_blocks_view(
                zone_id, block_off + p * pages_per_read, pages_per_read)
        # Lookahead only runs when there is transfer time to hide (the device
        # models bandwidth); against pure host memory it would be all
        # overhead. Every bandwidth-modelling device is ring-capable, so the
        # pages stream as in-flight completion futures — no producer thread:
        # the emulated transfer of pages p+1..p+depth elapses on the zone's
        # virtual clock while page p is being interpreted.
        if (n_pages > 1 and prefetch_depth > 0
                and getattr(device, "read_us_per_block", 0.0) > 0):
            with RingReader(
                    lambda p: device.submit_read(
                        zone_id, block_off + p * pages_per_read,
                        pages_per_read),
                    n_pages, depth=prefetch_depth) as reader:
                result = interpret_program(program, reader, n_pages,
                                           page_elems)
                result.read_seconds = reader.read_seconds
            return result
        return interpret_program(program, read_page, n_pages, page_elems)
    if tier not in (CsdTier.JIT, CsdTier.KERNEL):
        raise ValueError(f"unknown tier {tier!r}")
    torch_device = resolve_device(torch_device)
    if tier == CsdTier.JIT:
        build = lambda: jit_program(program, n_pages, page_elems,  # noqa: E731
                                    device=torch_device)
    else:
        # resolve_tier above already routed non-kernelizable programs to jit
        from repro_torch.kernels.zone_filter import ops as zf_ops
        build = lambda: zf_ops.kernel_program(  # noqa: E731
            program, n_pages, page_elems, device=torch_device)
    # the key names the device: CPU and CUDA executables never collide
    jp, compile_seconds, hit = cache.get_or_build(
        (tier, program, n_pages, page_elems, str(torch_device)), build)
    if traced:
        t = _trace.complete("csd.prepare", t)
    # steps 2,3: the zone extent, a typed view of the backing buffer
    t_r = time.perf_counter()
    pages = device.read_extent(zone_id, block_off, n_blocks,
                               dtype).reshape(n_pages, page_elems)
    read_seconds = time.perf_counter() - t_r
    if traced:
        t = _trace.complete("tier.read", t, tier=tier, zone=zone_id,
                            nblocks=n_blocks)
    zoned = isinstance(device, ZonedDevice)
    alias = _mapped.get(device) if zoned else None
    mapped = reads_in_place(_card(torch_device), tier, zoned,
                            None if alias is None else alias.card, pages.nbytes)
    t0 = time.perf_counter()
    pages_t, h2d_seconds = stage_extent(device, pages, torch_device,
                                        read_in_place=mapped)
    if traced:
        t = _trace.complete("tier.stage", t,
                            path="in_place" if mapped else "copy")
    out = jp.launch(pages_t)
    if traced:
        t = _trace.complete("tier.launch", t)
    value = jp.to_host(out)
    if traced:
        _trace.complete("tier.result", t)
    exec_seconds = time.perf_counter() - t0
    nbytes = (sum(v.nbytes for v in value) if isinstance(value, tuple)
              else value.nbytes)
    return OffloadResult(value, nbytes, n_pages,
                         insns_bound, exec_seconds, compile_seconds,
                         read_seconds=read_seconds,
                         cache_hits=int(hit), cache_misses=int(not hit),
                         h2d_seconds=h2d_seconds)


@dataclass
class OffloadStats:
    """Per-offload statistics (paper §3: runtime, #insns, JIT time, data
    movement saved)."""

    program: str
    tier: str
    zone_id: int
    pages: int
    bytes_read: int = 0               # storage -> compute (stayed inside device)
    bytes_returned: int = 0           # device -> host (crossed the link)
    insns_verified: int = 0
    insns_executed: int = 0
    verify_seconds: float = 0.0
    jit_seconds: float = 0.0
    exec_seconds: float = 0.0
    read_seconds: float = 0.0         # time inside device transfers
    h2d_seconds: float = 0.0          # host->card copy (part of exec_seconds)
    cache_hits: int = 0               # shared compile-cache hits this offload
    cache_misses: int = 0

    @property
    def movement_saved_bytes(self) -> int:
        """Bytes that did NOT cross the host link thanks to the offload."""
        return max(self.bytes_read - self.bytes_returned, 0)

    @property
    def reduction_factor(self) -> float:
        return self.bytes_read / max(self.bytes_returned, 1)

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0


class CsdTier:
    INTERP = "interp"
    JIT = "jit"
    KERNEL = "kernel"


class NvmCsd:
    """A Zoned Computational Storage Device.

    ``zoned`` is the ZNS device that holds the data; ``device`` is where the
    jit and kernel tiers compute (default ``"cuda"``; it raises when CUDA is
    absent, so pass ``device="cpu"`` to run the plain PyTorch paths). On
    CUDA the zone memory is page-locked and mapped here, once
    (:func:`pin_zone_memory`), so the kernel tier reads a small extent in
    place and any other offload moves its extent to the card in a single
    DMA.

    ``pages_per_read`` controls the device-internal streaming granularity
    (paper default: one 4 KiB block per access). ``cache`` holds prepared
    executables for every tier; pass one :func:`repro_torch.core.cache.default_cache`
    (or any shared :class:`CompiledProgramCache`) to reuse them across CSD
    instances — programs are zone-agnostic, and the cache key names the
    compute device.
    """

    def __init__(
        self,
        zoned: ZonedDevice,
        *,
        device="cuda",
        default_tier: str = CsdTier.JIT,
        pages_per_read: int = 1,
        limits: VerifierLimits = VerifierLimits(),
        max_workers: int = 2,
        cache: Optional[CompiledProgramCache] = None,
        prefetch_depth: int = 2,
    ):
        self.torch_device = resolve_device(device)
        if self.torch_device.type == "cuda" and isinstance(zoned, ZonedDevice):
            with torch.cuda.device(self.torch_device):  # the alias's device
                pin_zone_memory(zoned)
        self.device = zoned
        self.default_tier = default_tier
        self.pages_per_read = int(pages_per_read)
        self.limits = limits
        self.prefetch_depth = int(prefetch_depth)
        self._result: Optional[OffloadResult] = None
        self.cache = cache if cache is not None else CompiledProgramCache()
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=max_workers)

    # ------------------------------------------------------- part-ii hooks
    def bpf_get_lba_size(self) -> int:
        return self.device.lba_size

    def bpf_get_mem_info(self) -> tuple[int, int]:
        """(scratch bytes available, block bytes) — the device-memory budget
        an offloaded program may assume; the same 16 MiB contract as the
        reference, so a program sees one budget on either package."""
        return 16 * 1024 * 1024, self.device.lba_size

    def bpf_read(self, zone_id: int, block_off: int, n_blocks: int) -> np.ndarray:
        """Bounds-checked read used by the interpreter tier (device enforces
        the write-pointer bound; the verifier proved the static extent)."""
        return self.device.read_blocks(zone_id, block_off, n_blocks)

    def bpf_return_data(self, data: OffloadResult) -> None:
        self._result = data

    # --------------------------------------------------------- part-i API
    def nvm_cmd_bpf_run(
        self,
        program: Program,
        zone_id: int,
        *,
        block_off: int = 0,
        n_blocks: Optional[int] = None,
        tier: Optional[str] = None,
    ) -> OffloadStats:
        """Verify + execute ``program`` against a zone extent. Synchronous:
        returns once the (reduced) result is available via
        :meth:`nvm_cmd_bpf_result`.

        Traced, the command is one ``csd.command`` span tagged with a
        process-wide ``cmd`` id, which every span inside it inherits."""
        if not _trace._enabled:
            return self._run(program, zone_id, block_off, n_blocks, tier, None)
        with _trace.span("csd.command", cmd=next(_cmd_ids), zone=zone_id) as root:
            return self._run(program, zone_id, block_off, n_blocks, tier, root)

    def _run(self, program: Program, zone_id: int, block_off: int,
             n_blocks: Optional[int], tier: Optional[str], root) -> OffloadStats:
        """:meth:`nvm_cmd_bpf_run`'s body inside ``root``, its open span
        (``None`` untraced); each step is a span that ends as the next
        begins."""
        if root is not None:
            t = time.monotonic()
        tier = resolve_tier(tier or self.default_tier, program)
        zone = self.device.zone(zone_id)
        if n_blocks is None:
            n_blocks = zone.write_pointer - block_off
        dtype = np.dtype(program.input_dtype)
        block_bytes = self.device.block_bytes
        page_elems, n_pages = extent_geometry(
            block_bytes, dtype, n_blocks, self.pages_per_read)
        if root is not None:
            root.tag(tier=tier, nblocks=n_blocks)
            t = _trace.complete("csd.prepare", t)

        # steps 4: verify (static program + the zone extent it may touch)
        t0 = time.perf_counter()
        insns_verified = verify_program(
            program, page_elems=page_elems, n_pages=n_pages, limits=self.limits
        )
        verify_zone_access(
            zone_write_pointer=zone.write_pointer, block_off=block_off,
            n_blocks=n_blocks,
        )
        verify_seconds = time.perf_counter() - t0
        if root is not None:
            _trace.complete("csd.verify", t)

        stats = OffloadStats(
            program=program.name, tier=tier, zone_id=zone_id, pages=n_pages,
            insns_verified=insns_verified, verify_seconds=verify_seconds,
            bytes_read=n_blocks * block_bytes,
        )

        result = execute_extent(
            self.device, program, zone_id, block_off, n_blocks,
            tier=tier, pages_per_read=self.pages_per_read,
            cache=self.cache, prefetch_depth=self.prefetch_depth,
            torch_device=self.torch_device,
        )
        stats.jit_seconds = result.compile_seconds
        stats.insns_executed = result.insns_executed
        stats.exec_seconds = result.exec_seconds
        stats.read_seconds = result.read_seconds
        stats.h2d_seconds = result.h2d_seconds
        stats.bytes_returned = result.bytes_returned
        stats.cache_hits = result.cache_hits
        stats.cache_misses = result.cache_misses
        self.bpf_return_data(result)
        return stats

    def nvm_cmd_bpf_result(self) -> object:
        """Fetch the last offload's result (paper API line 8)."""
        if self._result is None:
            raise RuntimeError("no offload result available")
        return self._result.value

    # ------------------------------------------------- async extension
    def nvm_cmd_bpf_run_async(
        self, program: Program, zone_id: int, **kw
    ) -> concurrent.futures.Future:
        """Asynchronous execution (the paper's stated future extension)."""
        return self._pool.submit(self.nvm_cmd_bpf_run, program, zone_id, **kw)

    # ---------------------------------------------------------- helpers
    def run_and_fetch(self, program: Program, zone_id: int, **kw):
        stats = self.nvm_cmd_bpf_run(program, zone_id, **kw)
        return self.nvm_cmd_bpf_result(), stats

    def oracle(self, program: Program, zone_id: int, *, block_off: int = 0,
               n_blocks: Optional[int] = None):
        """Host-side reference execution (reads the WHOLE extent over the
        link — the "no CSD" baseline; the link transfer is the point, the
        typed view just avoids gratuitous extra host copies)."""
        zone = self.device.zone(zone_id)
        if n_blocks is None:
            n_blocks = zone.write_pointer - block_off
        return run_oracle(program, self.device.read_extent(
            zone_id, block_off, n_blocks, np.dtype(program.input_dtype)))
