"""Wrappers of the hand-written Hopper kernel ``csrc/zone_filter.cu``.

``filtered_reduce`` replaces
``src/repro/kernels/zone_filter/kernel.py::filtered_reduce_pallas`` and
``filtered_reduce_batched`` replaces ``::filtered_reduce_pallas_batched``;
both launch the same CUDA source (the single zone is the batched kernel with
one chunk). A verified program's ALU/CMP chain reaches the kernel encoded
(:func:`repro_torch.kernels.zone_filter.ops.encode_program`): an int32
opcode tensor and an int64 immediate tensor on the card.

A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a CUDA
tensor launches the kernel or raises. Each wrapper counts its launches in
its ``launches`` attribute.

A call on the card is one kernel launch and one allocation, its result.
What depends only on the type, kind and shape is checked once (``_plan``);
the kernel's partials and per-chunk tickets live in a workspace kept for
each (device, stream) (:class:`Workspaces`), so that two streams never share
one while their launches may overlap.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.zone_filter.ref import (
    KINDS,
    acc_dtype,
    decode_transform,
    filtered_reduce_batched_ref,
)

__all__ = ["filtered_reduce", "filtered_reduce_batched", "blocks_per_chunk",
           "load", "SOURCE", "Workspaces"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "zone_filter.cu"

_DTYPE_CODE = {torch.int32: 0, torch.int64: 1, torch.uint32: 2,
               torch.float32: 3, torch.float64: 4}
_TILE_BYTES = 256 * 2 * 16      # threads x 16-byte loads per thread, per tile
_MAX_BLOCKS_PER_CHUNK = 1024    # about two waves on 132 SMs at 4 blocks of 256 each


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library; later calls
    return it without touching the source again."""
    lib = _build.load_library(SOURCE)
    fn = lib.zf_filtered_reduce
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def blocks_per_chunk(chunk_elems: int, itemsize: int) -> int:
    """Blocks per chunk. A function of the chunk's size alone, so a batched
    row folds its partials exactly as the chunk run alone does."""
    tiles = -(-chunk_elems * itemsize // _TILE_BYTES)
    return max(1, min(_MAX_BLOCKS_PER_CHUNK, tiles))


class Workspaces:
    """The kernel's partials (8 bytes a block) and per-chunk tickets, one
    pair for each (device, stream), behind a lock.

    A pair grows when a launch needs more and never shrinks, so once the
    largest shape has been seen a call allocates nothing here. The tickets
    start at 0 and every launch leaves them at 0. Launches on one stream run
    in order, so they may share a pair; launches on two streams may overlap
    on the card, so each stream has its own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._held: dict = {}

    def reserve(self, device, stream: int, n_chunks: int,
                bpc: int) -> tuple[torch.Tensor, torch.Tensor]:
        """``(partials, tickets)`` for ``n_chunks`` x ``bpc`` blocks on
        ``stream`` of ``device`` (a CUDA ordinal or a torch device): at
        least that many int64 slots and int32 tickets. New tensors are made
        on the current stream, which must be ``stream``. The caller holds
        them until its launch is enqueued."""
        key = (device, stream)
        held = self._held.get(key)          # a pair is replaced, never changed
        if (held is not None and held[0].numel() >= n_chunks * bpc
                and held[1].numel() >= n_chunks):
            return held
        with self._lock:
            held = self._held.get(key)
            if (held is None or held[0].numel() < n_chunks * bpc
                    or held[1].numel() < n_chunks):
                n_slots = max(n_chunks * bpc, held[0].numel() if held else 0)
                n_tickets = max(n_chunks, held[1].numel() if held else 0)
                held = self._held[key] = (
                    torch.empty(n_slots, dtype=torch.int64, device=device),
                    torch.zeros(n_tickets, dtype=torch.int32, device=device))
            return held


_WORKSPACES = Workspaces()


class _Plan(NamedTuple):
    dtype_code: int
    kind_code: int
    out_like: torch.Tensor      # the result's shape, type and device
    n_chunks: int
    chunk_elems: int
    bpc: int


@functools.lru_cache(maxsize=1024)
def _plan(dtype: torch.dtype, kind: str, shape: torch.Size, batched: bool,
          device) -> _Plan:
    """The launch's arguments that depend on nothing but the zone's type,
    the kind, the shape and the device (a CUDA ordinal or a torch device),
    checked once for each. The result is allocated like ``out_like``
    (``torch.empty_like`` parses no arguments)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported zone dtype {dtype}")
    out_dtype = acc_dtype(kind, dtype)       # raises on an unknown kind
    n_chunks = (shape[0] if shape else 0) if batched else 1
    chunk_elems = math.prod(shape[1:] if batched else shape)
    if not 1 <= n_chunks <= 65535 or chunk_elems == 0:
        raise ValueError(f"need 1..65535 non-empty chunks, got shape {tuple(shape)}")
    out_like = torch.empty((n_chunks,) if batched else (), dtype=out_dtype, device=device)
    return _Plan(_DTYPE_CODE[dtype], KINDS.index(kind), out_like, n_chunks, chunk_elems,
                 blocks_per_chunk(chunk_elems, dtype.itemsize))


def _launch(pages: torch.Tensor, kind: str, ops: Optional[torch.Tensor],
            imms: Optional[torch.Tensor], batched: bool) -> torch.Tensor:
    """One launch over ``pages`` on the current stream: ``[n_chunks]`` when
    ``batched``, else 0-d."""
    idx = pages.get_device()
    plan = _plan(pages.dtype, kind, pages.shape, batched, idx)
    if not pages.is_contiguous():
        raise ValueError("pages must be contiguous")
    x = pages.data_ptr()
    if x % 16:
        raise ValueError("pages must be 16-byte aligned")
    if ops is None:                 # no program: the kernel reads no opcode
        ops_ptr = imms_ptr = n_insns = 0
    else:
        if (imms is None or ops.dtype != torch.int32 or imms.dtype != torch.int64
                or ops.get_device() != idx or imms.get_device() != idx
                or not (ops.is_contiguous() and imms.is_contiguous())):
            raise ValueError(f"ops and imms must be contiguous int32 and int64 "
                             f"tensors on {pages.device}")
        n_insns = ops.numel()
        if imms.numel() != n_insns:
            raise ValueError("ops and imms differ in length")
        ops_ptr, imms_ptr = ops.data_ptr(), imms.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(idx)
    partials, tickets = _WORKSPACES.reserve(idx, stream, plan.n_chunks, plan.bpc)
    out = torch.empty_like(plan.out_like)
    err = load().zf_filtered_reduce(
        plan.dtype_code, plan.kind_code, x, plan.n_chunks, plan.chunk_elems,
        ops_ptr, imms_ptr, n_insns, partials.data_ptr(), tickets.data_ptr(),
        plan.bpc, out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"zone_filter kernel launch failed: cudaError {err}")
    return out


def _plain(pages: torch.Tensor, kind: str, ops, imms) -> torch.Tensor:
    transform = None if ops is None else decode_transform(
        ops, imms, u32=pages.dtype == torch.uint32)
    return filtered_reduce_batched_ref(pages, kind, transform)


def filtered_reduce_batched(pages: torch.Tensor, *, kind: str = "count",
                            ops: Optional[torch.Tensor] = None,
                            imms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Chunk-batched filtered reduction: ``pages[n_chunks, n_pages,
    page_elems]`` -> ``[n_chunks]`` in the reference's accumulator type.
    ``ops``/``imms`` is the encoded program (identity when ``ops`` is None).
    Every row is bit-identical to :func:`filtered_reduce` on that chunk."""
    if pages.is_cpu:
        return _plain(pages, kind, ops, imms)
    if not pages.is_cuda:
        raise ValueError(f"unsupported device {pages.device}")
    out = _launch(pages, kind, ops, imms, True)
    filtered_reduce_batched.launches += 1
    return out


def filtered_reduce(pages: torch.Tensor, *, kind: str = "count",
                    ops: Optional[torch.Tensor] = None,
                    imms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Filtered reduction over one zone ``pages[n_pages, page_elems]`` -> a
    0-d tensor: int32 count, float32 sum of a float zone (int32 for an
    integer zone), or the min/max in the zone's type."""
    if pages.is_cpu:
        return _plain(pages.unsqueeze(0), kind, ops, imms)[0]
    if not pages.is_cuda:
        raise ValueError(f"unsupported device {pages.device}")
    out = _launch(pages, kind, ops, imms, False)
    filtered_reduce.launches += 1
    return out


filtered_reduce.launches = 0
filtered_reduce_batched.launches = 0
