"""Wrapper of the hand-written Hopper kernel ``csrc/paged_attn.cu``.

``paged_attention_kernel`` replaces
``src/repro/kernels/paged_attn/kernel.py::paged_attention_pallas``: one
decode step of attention for each sequence, read in place from a zoned KV
pool through its zone table. The zone table and the lengths stay on the
card; the launch needs no host sync.

On the card one call runs two kernels: ``paged_partial`` over runs of
zones (``split_layout``) into a float32 workspace, then ``paged_combine``.
A tensor on the CPU goes to the plain PyTorch version in ``ref.py``; a CUDA
tensor launches both kernels or raises. The wrapper counts its calls that
launched in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn.ref import paged_attention_ref

__all__ = ["paged_attention_kernel", "split_layout", "load", "SOURCE", "MAX_HEAD_DIM"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attn.cu"
MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    lib = _build.load_library(SOURCE)
    fn = lib.pa_paged_attention
    fn.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 7, *[ctypes.c_int] * 9,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pa_workspace_floats.argtypes = [ctypes.c_int] * 5
    lib.pa_workspace_floats.restype = ctypes.c_longlong
    return lib


def split_layout(MZ: int, ZL: int) -> tuple[int, int]:
    """(zones a split, splits) for a table of ``MZ`` zones of ``ZL`` tokens:
    about 256 tokens a split. From shapes alone, so no host sync."""
    zps = max(1, 256 // ZL)
    return zps, -(-MZ // zps)


def _check(q, k_zones, v_zones, zone_table, lengths) -> None:
    """Raise on anything the kernel does not take."""
    if q.dim() != 3 or k_zones.dim() != 4:
        raise ValueError(f"need q [B, H, hd] and zones [NZ, ZL, KV, hd], got "
                         f"{tuple(q.shape)} and {tuple(k_zones.shape)}")
    B, H, hd = q.shape
    NZ, ZL, KV, khd = k_zones.shape
    if v_zones.shape != k_zones.shape:
        raise ValueError(f"k_zones {tuple(k_zones.shape)} and v_zones "
                         f"{tuple(v_zones.shape)} differ")
    if khd != hd or KV < 1 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit zones "
                         f"{tuple(k_zones.shape)}: need the same head_dim and "
                         "H a multiple of KV")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: the kernel takes multiples of 8 up "
                         f"to {MAX_HEAD_DIM}")
    if q.dtype not in _DTYPE_CODE or k_zones.dtype != q.dtype or v_zones.dtype != q.dtype:
        raise TypeError(f"q, k_zones and v_zones must share one dtype of "
                        f"float32/bfloat16, got {q.dtype}, {k_zones.dtype}, "
                        f"{v_zones.dtype}")
    if zone_table.dim() != 2 or zone_table.shape[0] != B or zone_table.dtype != torch.int32:
        raise ValueError(f"zone_table must be int32 [B={B}, MZ], got "
                         f"{zone_table.dtype} {tuple(zone_table.shape)}")
    if lengths.shape != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 [B={B}], got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    MZ = zone_table.shape[1]
    if min(NZ, ZL, MZ) < 1 or MZ * ZL > _INT_MAX or B * H > _INT_MAX:
        raise ValueError(f"unsupported sizes NZ={NZ}, ZL={ZL}, MZ={MZ}, B={B}")
    for name, t in (("q", q), ("k_zones", k_zones), ("v_zones", v_zones),
                    ("zone_table", zone_table), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_zones", k_zones), ("v_zones", v_zones)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_attention_kernel(q: torch.Tensor, k_zones: torch.Tensor,
                           v_zones: torch.Tensor, zone_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q ``[B, H, hd]``; k_zones/v_zones ``[NZ, ZL, KV, hd]``; zone_table
    ``[B, MZ]`` int32 (-1 = unused); lengths ``[B]`` int32 ->
    ``[B, H, hd]`` in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_zones, v_zones, zone_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k_zones, v_zones, zone_table, lengths)
    out = torch.empty_like(q)
    if q.shape[0] == 0:
        return out
    B, H, hd = q.shape
    NZ, ZL, KV, _ = k_zones.shape
    MZ = zone_table.shape[1]
    zps, S = split_layout(MZ, ZL)
    lib = load()
    floats = lib.pa_workspace_floats(B, H, KV, hd, S)
    if floats < 0:
        raise ValueError(f"unsupported sizes B={B}, H={H}, KV={KV}, hd={hd}, {S} splits")
    ws = torch.empty(floats, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pa_paged_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_zones.data_ptr(), v_zones.data_ptr(),
        zone_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
        B, H, KV, hd, NZ, ZL, MZ, zps, S, hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"paged_attn kernel launch failed: cudaError {err}")
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0
