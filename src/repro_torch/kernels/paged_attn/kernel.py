"""Wrapper of the hand-written Hopper kernel ``csrc/paged_attn.cu``.

``paged_attention_kernel`` replaces
``src/repro/kernels/paged_attn/kernel.py::paged_attention_pallas``: one
decode step of attention for each sequence, read in place from a zoned KV
pool through its zone table. The zone table and the lengths stay on the
card; the launch needs no host sync.

On the card one call runs two kernels: ``paged_partial`` over runs of
zones into a float32 workspace, then ``paged_combine``. ``plan`` sizes
both from the shapes and the card's SM count: the CTA's heads, its
shared-memory ring of K/V stages and the split count. A tensor on the CPU
goes to the plain PyTorch version in ``ref.py``; a CUDA tensor launches
both kernels or raises. The wrapper counts its calls that launched in its
``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn.ref import paged_attention_ref

__all__ = ["paged_attention_kernel", "plan", "Plan", "smem_bytes", "load", "SOURCE",
           "MAX_HEAD_DIM", "SMEM_LIMIT", "cta_shape"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attn.cu"
MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1

# The CTA of paged_partial (csrc/paged_attn.cu): one producer warp and up
# to 8 consumer warps, one a column of 4 query heads of one KV head.
CONSUMER_WARPS = 8
HEADS_A_COLUMN = 4
SMEM_LIMIT = 232_448            # dynamic shared memory of one block on an H100
STAGE_TARGET = 64 * 1024        # K and V bytes of one stage
STAGES = 3
MAX_STAGE_TOKENS = 16           # 4 a lane group of 8 lanes
WAVES = 4                       # CTAs an SM, at a full zone table
MIN_SPLIT_TOKENS = 256          # a split's zones hold at least this many slots


@dataclass(frozen=True)
class Plan:
    """How one call is cut. A CTA covers ``kv_chunk`` KV heads and
    ``head_groups`` columns of 4 of each one's query heads, in a ring of
    ``stages`` stages of ``stage_tokens`` tokens, each token one bulk-copied
    row of ``row_bytes`` of K and one of V (``smem`` bytes of dynamic shared
    memory in all); each sequence is split into ``splits`` runs of
    ``zones_per_split`` zones; ``ctas`` CTAs in all."""
    kv_chunk: int
    head_groups: int
    stage_tokens: int
    stages: int
    row_bytes: int
    smem: int
    zones_per_split: int
    splits: int
    ctas: int


def cta_shape(H: int, KV: int, hd: int) -> tuple[int, int]:
    """(KV heads, columns of 4 query heads of each) of one CTA: at most 8
    columns, as many whole KV heads as fit, else a divisor of one KV
    head's columns."""
    hgs = -(-(H // KV) // HEADS_A_COLUMN)
    if hgs <= CONSUMER_WARPS:
        return max(d for d in range(1, KV + 1)
                   if KV % d == 0 and d * hgs <= CONSUMER_WARPS), hgs
    return 1, max(d for d in range(1, CONSUMER_WARPS + 1) if hgs % d == 0)


def smem_bytes(hd: int, itemsize: int, kv_chunk: int, stage_tokens: int, stages: int) -> int:
    """paged_partial's dynamic shared memory (csrc/paged_attn.cu::
    smem_layout): the K/V ring (each token's row padded by 16 bytes), a p
    buffer a consumer warp, two barriers a stage."""
    ring = stages * 2 * stage_tokens * (kv_chunk * hd * itemsize + 16)
    return ring + CONSUMER_WARPS * MAX_STAGE_TOKENS * HEADS_A_COLUMN * 4 + 2 * stages * 8


def plan(B: int, H: int, KV: int, hd: int, MZ: int, ZL: int, itemsize: int,
         sm_count: int) -> Plan:
    """The CTA, its stages and the split count, from the shapes and the
    card's SM count alone (no length is read, so no host sync).

    A stage holds about 64 KiB of K and V (a row is at most 8 KV heads x
    256 x 4 bytes, so 3 stages stay within 200 KB); 3 stages. The split: the table's
    width MZ bounds the zones a row uses, so S is sized for about ``WAVES``
    waves of CTAs at a full table (one to two at a half or quarter full one),
    and S = 1 once the sequences alone give more than two waves; a split
    covers at least ``MIN_SPLIT_TOKENS`` slots."""
    kvc, hgc = cta_shape(H, KV, hd)
    row = kvc * hd * itemsize
    tt = 1
    while tt * 2 <= MAX_STAGE_TOKENS and tt * 2 * 2 * row <= STAGE_TARGET:
        tt *= 2
    smem = smem_bytes(hd, itemsize, kvc, tt, STAGES)
    per_seq = (KV // kvc) * (-(-(H // KV) // HEADS_A_COLUMN) // hgc)
    rows = B * per_seq
    # one CTA an SM: the kernel may take up to 224 registers a thread
    target = max(1, WAVES * sm_count // rows)
    zps = min(MZ, max(-(-MZ // target), -(-MIN_SPLIT_TOKENS // ZL)))
    S = -(-MZ // zps)
    return Plan(kvc, hgc, tt, STAGES, row, smem, zps, S, rows * S)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def load() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library."""
    lib = _build.load_library(SOURCE)
    fn = lib.pa_paged_attention
    fn.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 7, *[ctypes.c_int] * 13,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.pa_workspace_floats.argtypes = [ctypes.c_int] * 5
    lib.pa_workspace_floats.restype = ctypes.c_longlong
    lib.pa_smem_bytes.argtypes = [ctypes.c_int] * 8
    lib.pa_smem_bytes.restype = ctypes.c_longlong
    return lib


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
                           lengths: torch.Tensor, *,
                           zones_per_split: int | None = None) -> torch.Tensor:
    """q ``[B, H, hd]``; k_zones/v_zones ``[NZ, ZL, KV, hd]``; zone_table
    ``[B, MZ]`` int32 (-1 = unused); lengths ``[B]`` int32 ->
    ``[B, H, hd]`` in q's dtype. ``zones_per_split`` overrides ``plan``'s
    split (the card's checks run every case at S = 1 too)."""
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
    p = plan(B, H, KV, hd, MZ, ZL, q.element_size(), _sm_count(q.device.index or 0))
    zps, S = p.zones_per_split, p.splits
    if zones_per_split is not None:
        zps = min(MZ, max(1, zones_per_split))
        S = -(-MZ // zps)
    lib = load()
    floats = lib.pa_workspace_floats(B, H, KV, hd, S)
    if floats < 0:
        raise ValueError(f"unsupported sizes B={B}, H={H}, KV={KV}, hd={hd}, {S} splits")
    ws = torch.empty(floats, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pa_paged_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_zones.data_ptr(), v_zones.data_ptr(),
        zone_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), ws.data_ptr(),
        B, H, KV, hd, NZ, ZL, MZ, zps, S, p.kv_chunk, p.head_groups, p.stage_tokens,
        p.stages, hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"paged_attn kernel launch failed: cudaError {err}")
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0
