"""Zoned KV-cache manager: the ZNS abstraction applied to serving.

The port of ``src/repro/serve/kv_zones.py``. A KV cache is append-only
storage: each decode step appends one token's K/V and nothing is updated in
place afterwards, which is the write model ZNS zones mandate. The manager
maps sequences onto fixed-size KV zones from a shared pool:

  * a sequence owns an ordered list of zones (its zone-table row);
  * appending K/V advances the active zone's write pointer; when it is full,
    a new zone is allocated from the front of the free list;
  * evicting a sequence is a host-managed reset of its zones back to the end
    of the free list (no device-side GC ever moves data);
  * attention over a sequence's history runs in place over the pool through
    the paged-attention kernel (:mod:`repro_torch.kernels.paged_attn`).

In PyTorch the pool is two preallocated ``[NZ, ZL, KV, hd]`` tensors on an
explicit device, and a Zone Append writes one token slot of each in place
(the reference rebuilds its arrays with ``.at[].set``).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch._device import host_to_device, resolve_device
from repro_torch.kernels.paged_attn.ops import paged_attention
from repro_torch.telemetry.metrics import MetricsRegistry, StatsView

_POOL_SEQ = itertools.count()

__all__ = ["KVZonePool", "KVZoneError", "pool_from_reference"]


class KVZoneError(Exception):
    pass


@dataclass
class _SeqState:
    zones: list[int] = field(default_factory=list)
    length: int = 0


class KVZonePool:
    """num_zones zones of zone_len tokens each, [KV, head_dim] per token,
    on ``device`` (default the card; raises without CUDA)."""

    def __init__(self, *, num_zones: int, zone_len: int, kv_heads: int,
                 head_dim: int, max_zones_per_seq: int,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        self.num_zones = num_zones
        self.zone_len = zone_len
        self.max_zones_per_seq = max_zones_per_seq
        shape = (num_zones, zone_len, kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self._free = list(range(num_zones))
        self._seqs: dict[int, _SeqState] = {}
        # pool counters on a private registry (pools are unbounded);
        # `stats` keeps its dict shape as a live view
        self.metrics = MetricsRegistry(f"kvpool{next(_POOL_SEQ)}")
        self._c_alloc = self.metrics.counter("zones_allocated")
        self._c_reset = self.metrics.counter("zones_reset")
        self._c_tokens = self.metrics.counter("tokens_appended")
        self.stats = StatsView({"zones_allocated": self._c_alloc,
                                "zones_reset": self._c_reset,
                                "tokens_appended": self._c_tokens})

    # ---------------------------------------------------------- lifecycle
    def add_sequence(self, seq_id: int) -> None:
        if seq_id in self._seqs:
            raise KVZoneError(f"sequence {seq_id} exists")
        self._seqs[seq_id] = _SeqState()

    def evict(self, seq_id: int) -> None:
        """Host-managed GC: reset the sequence's zones back to the pool."""
        st = self._seqs.pop(seq_id, None)
        if st is None:
            return
        for z in st.zones:
            self._free.append(z)
        self._c_reset.inc(len(st.zones))

    def _alloc_zone(self, st: _SeqState) -> int:
        if len(st.zones) >= self.max_zones_per_seq:
            raise KVZoneError("sequence exceeds max_zones_per_seq")
        if not self._free:
            raise KVZoneError("zone pool exhausted (evict something)")
        z = self._free.pop(0)
        st.zones.append(z)
        self._c_alloc.inc()
        return z

    # ------------------------------------------------------------- append
    def append(self, seq_id: int, k_tok: torch.Tensor, v_tok: torch.Tensor) -> None:
        """Append one token's K/V ([KV, head_dim], any device and float
        dtype; cast to the pool's) — the Zone Append, written in place."""
        st = self._seqs[seq_id]
        slot = st.length % self.zone_len
        if slot == 0:
            self._alloc_zone(st)
        z = st.zones[-1]
        self.k[z, slot].copy_(torch.as_tensor(k_tok))
        self.v[z, slot].copy_(torch.as_tensor(v_tok))
        st.length += 1
        self._c_tokens.inc()

    def extend(self, seq_id: int, k_toks: torch.Tensor, v_toks: torch.Tensor) -> None:
        """Append n tokens' K/V (``[n, KV, head_dim]``) as n calls of
        :meth:`append` would, zones and errors included, with one in-place
        copy per zone run instead of one per token."""
        k_toks, v_toks = torch.as_tensor(k_toks), torch.as_tensor(v_toks)
        if k_toks.dim() != 3 or k_toks.shape != v_toks.shape:
            raise ValueError(f"need k and v of one [n, KV, head_dim] shape, got "
                             f"{tuple(k_toks.shape)} and {tuple(v_toks.shape)}")
        st = self._seqs[seq_id]
        done = 0
        while done < len(k_toks):
            slot = st.length % self.zone_len
            if slot == 0:
                self._alloc_zone(st)
            run = min(len(k_toks) - done, self.zone_len - slot)
            z = st.zones[-1]
            self.k[z, slot:slot + run].copy_(k_toks[done:done + run])
            self.v[z, slot:slot + run].copy_(v_toks[done:done + run])
            st.length += run
            done += run
            self._c_tokens.inc(run)

    # ---------------------------------------------------------- attention
    def zone_table(self, seq_ids: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """(int32 ``[B, max_zones_per_seq]`` zone ids, -1 = unused; int32
        ``[B]`` lengths), built on the host and copied to the pool's device
        once each."""
        tab = np.full((len(seq_ids), self.max_zones_per_seq), -1, np.int32)
        lengths = np.zeros((len(seq_ids),), np.int32)
        for i, sid in enumerate(seq_ids):
            st = self._seqs[sid]
            tab[i, : len(st.zones)] = st.zones
            lengths[i] = st.length
        return host_to_device(tab, self.device), host_to_device(lengths, self.device)

    def attend(self, seq_ids: list[int], q: torch.Tensor) -> torch.Tensor:
        """q: [B, H, head_dim] (B == len(seq_ids)) on the pool's device.
        Flash-decode over the zone pool through the paged-attention kernel."""
        tab, lengths = self.zone_table(seq_ids)
        return paged_attention(q, self.k, self.v, tab, lengths)

    def utilization(self) -> float:
        used = self.num_zones - len(self._free)
        return used / self.num_zones


def _pool_tensor(a: np.ndarray) -> torch.Tensor:
    """A host tensor with the bits of ``a``. A bfloat16 array (numpy's view of
    a jnp bfloat16 array) is read as uint16 and viewed as torch.bfloat16,
    since ``torch.from_numpy`` does not take that dtype."""
    cpu = torch.device("cpu")
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        return host_to_device(np.ascontiguousarray(a).view(np.uint16), cpu).view(torch.bfloat16)
    return host_to_device(a, cpu)


def pool_from_reference(k: np.ndarray, v: np.ndarray, seqs: Mapping[int, object],
                        free: Iterable[int], *, zone_len: int, max_zones_per_seq: int,
                        device="cuda") -> KVZonePool:
    """The port's pool holding a reference pool's state: its K/V
    (``np.asarray`` of the reference's ``k``/``v``), its sequences (each with
    ``zones`` and ``length``, as the reference's ``_seqs``) and its free list
    in order. K/V bits are copied exactly; the counters start at 0."""
    kt, vt = _pool_tensor(k), _pool_tensor(v)
    if kt.shape != vt.shape or kt.dtype != vt.dtype or kt.dim() != 4:
        raise ValueError(f"k {tuple(kt.shape)} {kt.dtype} and v {tuple(vt.shape)} "
                         f"{vt.dtype} must be one [NZ, ZL, KV, hd] shape and dtype")
    num_zones, zl, kv_heads, head_dim = kt.shape
    if zl != zone_len:
        raise ValueError(f"zone_len {zone_len} but the pool's zones hold {zl} tokens")
    pool = KVZonePool(num_zones=num_zones, zone_len=zone_len, kv_heads=kv_heads,
                      head_dim=head_dim, max_zones_per_seq=max_zones_per_seq,
                      dtype=kt.dtype, device=device)
    pool.k.copy_(kt)
    pool.v.copy_(vt)
    pool._free = [int(z) for z in free]
    pool._seqs = {int(sid): _SeqState([int(z) for z in st.zones], int(st.length))
                  for sid, st in seqs.items()}
    return pool
