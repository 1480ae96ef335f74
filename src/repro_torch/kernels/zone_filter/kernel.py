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
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.zone_filter.ref import (
    KINDS,
    acc_dtype,
    decode_transform,
    filtered_reduce_batched_ref,
)

__all__ = ["filtered_reduce", "filtered_reduce_batched", "blocks_per_chunk",
           "load", "SOURCE"]

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
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def blocks_per_chunk(chunk_elems: int, itemsize: int) -> int:
    """Pass-1 blocks per chunk. A function of the chunk's size alone, so a
    batched row folds its partials exactly as the chunk run alone does."""
    tiles = -(-chunk_elems * itemsize // _TILE_BYTES)
    return max(1, min(_MAX_BLOCKS_PER_CHUNK, tiles))


def _empty_program(device: torch.device):
    return (torch.empty(0, dtype=torch.int32, device=device),
            torch.empty(0, dtype=torch.int64, device=device))


def _launch(pages: torch.Tensor, kind: str, ops: torch.Tensor,
            imms: torch.Tensor) -> torch.Tensor:
    """Both passes of the kernel over ``pages[n_chunks, ...]`` -> ``[n_chunks]``."""
    if pages.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported zone dtype {pages.dtype}")
    if not pages.is_contiguous():
        raise ValueError("pages must be contiguous")
    if pages.data_ptr() % 16:
        raise ValueError("pages must be 16-byte aligned")
    n_chunks = pages.shape[0]
    chunk_elems = pages[0].numel() if n_chunks else 0
    if not 1 <= n_chunks <= 65535 or chunk_elems == 0:
        raise ValueError(f"need 1..65535 non-empty chunks, got shape "
                         f"{tuple(pages.shape)}")
    for name, t, dt in (("ops", ops, torch.int32), ("imms", imms, torch.int64)):
        if t.device != pages.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on "
                             f"{pages.device}")
    if ops.numel() != imms.numel():
        raise ValueError("ops and imms differ in length")
    out_dtype = acc_dtype(kind, pages.dtype)   # raises on an unknown kind
    bpc = blocks_per_chunk(chunk_elems, pages.element_size())
    partials = torch.empty(n_chunks * bpc, dtype=out_dtype, device=pages.device)
    out = torch.empty(n_chunks, dtype=out_dtype, device=pages.device)
    stream = torch.cuda.current_stream(pages.device).cuda_stream
    err = load().zf_filtered_reduce(
        _DTYPE_CODE[pages.dtype], KINDS.index(kind), pages.data_ptr(), n_chunks,
        chunk_elems, ops.data_ptr(), imms.data_ptr(), ops.numel(),
        partials.data_ptr(), bpc, out.data_ptr(), stream)
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
    ``ops``/``imms`` is the encoded program (identity when None). Every row
    is bit-identical to :func:`filtered_reduce` on that chunk."""
    if pages.device.type == "cpu":
        return _plain(pages, kind, ops, imms)
    if pages.device.type != "cuda":
        raise ValueError(f"unsupported device {pages.device}")
    if ops is None:
        ops, imms = _empty_program(pages.device)
    out = _launch(pages, kind, ops, imms)
    filtered_reduce_batched.launches += 1
    return out


def filtered_reduce(pages: torch.Tensor, *, kind: str = "count",
                    ops: Optional[torch.Tensor] = None,
                    imms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Filtered reduction over one zone ``pages[n_pages, page_elems]`` -> a
    0-d tensor: int32 count, float32 sum of a float zone (int32 for an
    integer zone), or the min/max in the zone's type."""
    if pages.device.type == "cpu":
        return _plain(pages.unsqueeze(0), kind, ops, imms)[0]
    if pages.device.type != "cuda":
        raise ValueError(f"unsupported device {pages.device}")
    if ops is None:
        ops, imms = _empty_program(pages.device)
    out = _launch(pages.unsqueeze(0), kind, ops, imms)[0]
    filtered_reduce.launches += 1
    return out


filtered_reduce.launches = 0
filtered_reduce_batched.launches = 0
