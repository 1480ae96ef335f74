"""Plain PyTorch version of the zone-admission kernel (``csrc/zone_admit.cu``).

One in-place copy of K and one of V a zone run, each over every layer: what
``KVZoneCache.admit`` did before the kernel, and still does for a cache on
the CPU. ``copy_`` takes a source of any device and float dtype.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["zone_admit_ref"]


def zone_admit_ref(k_pool: torch.Tensor, v_pool: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, zones: Sequence[int]) -> None:
    """Tokens ``[r * ZL, (r + 1) * ZL)`` of ``k``/``v`` (``[L, n, KV, hd]``)
    into zone ``zones[r]`` of the pools (``[L, NZ, ZL, KV, hd]``), from its
    slot 0; the last run's zone keeps its other slots."""
    zone_len, n = k_pool.shape[2], k.shape[1]
    for r, z in enumerate(zones):
        done = r * zone_len
        run = min(n - done, zone_len)
        k_pool[:, z, :run].copy_(k[:, done:done + run])
        v_pool[:, z, :run].copy_(v[:, done:done + run])
