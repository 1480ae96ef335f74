"""Wrapper of the hand-written kernel ``csrc/zone_admit.cu``: a prompt's K
and V (``[L, n, KV, hd]``) copied into its zones of a zoned cache's pools
(``[L, NZ, ZL, KV, hd]``), every layer and every zone run of K and of V in
one launch for up to ``MAX_ZONES`` zones (``KVZoneCache.admit``).

``plan`` checks what the kernel takes and cuts the call into launches; it
is pure Python. A pool on the CPU goes to the plain PyTorch version in
``ref.py``; a pool on the card launches the kernel or raises. The wrapper
launches on the current stream, allocates nothing and waits for nothing,
and counts its launches in its ``launches`` attribute: one an admission of
up to ``MAX_ZONES`` zones.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.zone_admit.ref import zone_admit_ref

__all__ = ["zone_admit", "plan", "Plan", "rows_dense", "load", "SOURCE", "MAX_ZONES"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "zone_admit.cu"
MAX_ZONES = 64                  # zone ids a launch: kMaxZones of the source
_MAX_LAYERS = 65535             # the grid's y
_INT_MAX = 2**31 - 1


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    lib = _build.load_library(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.za_admit.argtypes = [i32, *[ptr] * 4, *[i64] * 6, *[i32] * 4,
                             ctypes.POINTER(ctypes.c_int), ptr]
    lib.za_admit.restype = ctypes.c_int
    return lib


@dataclass(frozen=True)
class Plan:
    """One admission's launches. Strides are in bytes: ``src_layer`` and
    ``src_token`` of K and of V, ``dst_layer`` and ``dst_zone`` of the
    pools; ``unit`` the bytes a load, ``row_units`` the units of a token's
    ``[KV, hd]`` row. Each launch is ``(first token, tokens, zone ids)``."""
    unit: int
    row_units: int
    zone_len: int
    src_layer: tuple[int, int]
    src_token: tuple[int, int]
    dst_layer: int
    dst_zone: int
    launches: tuple[tuple[int, int, tuple[int, ...]], ...]


def rows_dense(t: torch.Tensor) -> bool:
    """Whether each token's ``[KV, hd]`` row of ``t`` (``[L, n, KV, hd]``)
    is one dense run of values, as the kernel reads it."""
    return ((t.shape[3] <= 1 or t.stride(3) == 1)
            and (t.shape[2] <= 1 or t.stride(2) == t.shape[3]))


def _check_shapes(k_pool, v_pool, k, v, zones) -> None:
    if k_pool.dim() != 5 or v_pool.shape != k_pool.shape:
        raise ValueError(f"zone_admit: need pools of one [L, NZ, ZL, KV, hd] shape, got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    L, NZ, ZL, KV, hd = k_pool.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != L or tuple(k.shape[2:]) != (KV, hd):
        raise ValueError(f"zone_admit: need k and v of one [{L}, n, {KV}, {hd}] shape, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    runs = -(-k.shape[1] // ZL)
    if len(zones) != runs:
        raise ValueError(f"zone_admit: {k.shape[1]} tokens fill {runs} zones of {ZL}, "
                         f"got {len(zones)} zone ids")
    if any(not 0 <= z < NZ for z in zones) or len(set(zones)) != len(zones):
        raise ValueError(f"zone_admit: zone ids must be distinct, in [0, {NZ}): {list(zones)}")


def plan(k_pool: torch.Tensor, v_pool: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         zones: Sequence[int]) -> Plan:
    """The kernel's launches for ``zone_admit``'s arguments, or the error
    for what it does not take: pools of one shape, contiguous; sources on
    the pools' device in their dtype, each token's row dense."""
    zones = [int(z) for z in zones]
    _check_shapes(k_pool, v_pool, k, v, zones)
    tensors = {"k_pool": k_pool, "v_pool": v_pool, "k": k, "v": v}
    for name, t in tensors.items():
        if t.device != k_pool.device:
            raise ValueError(f"zone_admit: {name} is on {t.device}, not {k_pool.device}")
        if t.dtype != k_pool.dtype:
            raise TypeError(f"zone_admit: {name} is {t.dtype}, the pool {k_pool.dtype}")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("zone_admit: the pools must be contiguous")
    if not (rows_dense(k) and rows_dense(v)):
        raise ValueError("zone_admit: each token's [KV, hd] row of k and v must be dense")
    L, NZ, ZL, KV, hd = k_pool.shape
    item = k_pool.element_size()
    row = KV * hd * item
    src_layer = (k.stride(0) * item, v.stride(0) * item)
    src_token = (k.stride(1) * item, v.stride(1) * item)
    unit = 16
    for x in (row, *src_layer, *src_token, *(t.data_ptr() for t in tensors.values())):
        while x % unit:
            unit //= 2
    if L > _MAX_LAYERS or row == 0 or ZL * (row // unit) > _INT_MAX:
        raise ValueError(f"zone_admit: unsupported pool {tuple(k_pool.shape)}")
    n = k.shape[1]
    launches = tuple((first * ZL, min(n - first * ZL, MAX_ZONES * ZL),
                      tuple(zones[first:first + MAX_ZONES]))
                     for first in range(0, len(zones), MAX_ZONES))
    return Plan(unit, row // unit, ZL, src_layer, src_token, NZ * ZL * row, ZL * row, launches)


def zone_admit(k_pool: torch.Tensor, v_pool: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               zones: Sequence[int]) -> None:
    """Tokens ``[r * ZL, (r + 1) * ZL)`` of ``k`` and ``v`` (``[L, n, KV,
    hd]``) into zone ``zones[r]`` of ``k_pool`` and ``v_pool`` (``[L, NZ,
    ZL, KV, hd]``) for every layer, in place; the last run's zone keeps its
    other slots. ``zones`` holds ``ceil(n / ZL)`` distinct ids."""
    if k_pool.device.type == "cpu":
        _check_shapes(k_pool, v_pool, k, v, [int(z) for z in zones])
        return zone_admit_ref(k_pool, v_pool, k, v, zones)
    if k_pool.device.type != "cuda":
        raise ValueError(f"zone_admit: unsupported device {k_pool.device}")
    p = plan(k_pool, v_pool, k, v, zones)
    if not p.launches:
        return
    lib = load()
    stream = torch.cuda.current_stream(k_pool.device).cuda_stream
    L = k_pool.shape[0]
    for first, n, ids in p.launches:
        err = lib.za_admit(p.unit, k.data_ptr() + first * p.src_token[0],
                           v.data_ptr() + first * p.src_token[1], k_pool.data_ptr(),
                           v_pool.data_ptr(), p.src_layer[0], p.src_token[0], p.src_layer[1],
                           p.src_token[1], p.dst_layer, p.dst_zone, L, p.row_units,
                           p.zone_len, n, (ctypes.c_int * len(ids))(*ids), stream)
        if err:
            raise RuntimeError(f"zone_admit launch failed: cudaError {err}")
        zone_admit.launches += 1


zone_admit.launches = 0
