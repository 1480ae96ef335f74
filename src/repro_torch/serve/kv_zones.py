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

:class:`KVZoneCache` is a model's whole cache in one allocation: ``[L, NZ,
ZL, KV, hd]`` K and V, one free list and one zone-table row a sequence for
all ``L`` layers, so ``k[l]`` is the pool the kernel reads for layer ``l``.
A decode step reserves its rows' slots and copies its zone table to the
card once (:meth:`KVZoneCache.reserve`), then writes and attends layer by
layer; a prompt's K/V for every layer goes into its zones with one launch of
the zone-admission kernel on the card (:meth:`KVZoneCache.admit`,
:mod:`repro_torch.kernels.zone_admit`; on the CPU its plain version, one
copy a zone run). Traced, it records ``kv.admit``, ``kv.evict``,
``kv.table``, ``kv.append`` (one layer's write) and ``kv.attend`` (one
layer's launch, host side).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch._device import host_tensor, host_to_device, resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attn import kernel as paged_kernel
from repro_torch.kernels.paged_attn.ops import paged_attention
from repro_torch.kernels.zone_admit import kernel as admit_kernel
from repro_torch.telemetry import trace
from repro_torch.telemetry.metrics import MetricsRegistry, StatsView

_POOL_SEQ = itertools.count()

__all__ = ["KVZonePool", "KVZoneCache", "ZoneStep", "KVZoneError", "pool_from_reference"]


class KVZoneError(Exception):
    pass


@dataclass
class _SeqState:
    zones: list[int] = field(default_factory=list)
    length: int = 0


class _ZoneAllocator:
    """The zones' bookkeeping that a pool of one layer and a cache of every
    layer share: the free list, each sequence's zone-table row and length,
    and the counters."""

    def _init_zones(self, num_zones: int, zone_len: int, max_zones_per_seq: int,
                    counters: tuple[str, ...] = ()) -> None:
        self.num_zones = num_zones
        self.zone_len = zone_len
        self.max_zones_per_seq = max_zones_per_seq
        self._free = list(range(num_zones))
        self._seqs: dict[int, _SeqState] = {}
        # pool counters on a private registry (pools are unbounded);
        # `stats` keeps its dict shape as a live view
        self.metrics = MetricsRegistry(f"kvpool{next(_POOL_SEQ)}")
        self._c_alloc = self.metrics.counter("zones_allocated")
        self._c_reset = self.metrics.counter("zones_reset")
        self._c_tokens = self.metrics.counter("tokens_appended")
        views = {"zones_allocated": self._c_alloc, "zones_reset": self._c_reset,
                 "tokens_appended": self._c_tokens}
        views.update((name, self.metrics.counter(name)) for name in counters)
        self.stats = StatsView(views)

    # ---------------------------------------------------------- lifecycle
    def add_sequence(self, seq_id: int) -> None:
        if seq_id in self._seqs:
            raise KVZoneError(f"sequence {seq_id} exists")
        self._seqs[seq_id] = _SeqState()

    def evict(self, seq_id: int) -> None:
        """Host-managed GC: reset the sequence's zones back to the pool."""
        with trace.span("kv.evict"):
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

    def _check_room(self, states: list[_SeqState], new_zones: list[int]) -> None:
        """Raise the error that appends in order would meet, ``states[i]``
        taking ``new_zones[i]`` new zones, before any zone is taken: each
        zone checks the sequence's cap, then the free list."""
        free = len(self._free)
        for st, n in zip(states, new_zones):
            at_cap = self.max_zones_per_seq - len(st.zones)    # zones until the cap
            if n > at_cap and at_cap <= free:
                raise KVZoneError("sequence exceeds max_zones_per_seq")
            if n > free:
                raise KVZoneError("zone pool exhausted (evict something)")
            free -= n

    def utilization(self) -> float:
        used = self.num_zones - len(self._free)
        return used / self.num_zones


class KVZonePool(_ZoneAllocator):
    """num_zones zones of zone_len tokens each, [KV, head_dim] per token,
    on ``device`` (default the card; raises without CUDA)."""

    def __init__(self, *, num_zones: int, zone_len: int, kv_heads: int,
                 head_dim: int, max_zones_per_seq: int,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        shape = (num_zones, zone_len, kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self._init_zones(num_zones, zone_len, max_zones_per_seq)

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


@dataclass(frozen=True)
class ZoneStep:
    """One decode step's rows in a :class:`KVZoneCache`: their new token's
    zone and slot, the step's zone table and lengths (the new token
    included) and each row's position (``lengths - 1``), all on the card:
    views of the cache's step buffer for ``B`` rows, copied into once a
    step, so every step of ``B`` rows reads its tensors at one address (a
    captured decode replays over them) and holds until the next
    :meth:`KVZoneCache.reserve` of ``B`` rows. A model's decode writes and
    attends through it, layer by layer. Zones and slots are int64, the
    index type of the layers' indexed writes; the rest int32, the paged
    kernel's."""

    cache: "KVZoneCache"
    zones: torch.Tensor          # [B] int64
    slots: torch.Tensor          # [B] int64
    lengths: torch.Tensor        # [B]
    positions: torch.Tensor      # [B]
    table: torch.Tensor          # [B, max_zones_per_seq], -1 = unused

    def write(self, layer: int, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        self.cache.write(layer, (self.zones, self.slots), k_new, v_new)

    def attend(self, layer: int, q: torch.Tensor) -> torch.Tensor:
        return self.cache.attend(layer, q, self.table, self.lengths)


class KVZoneCache(_ZoneAllocator):
    """Every layer's K/V in one zoned allocation: ``k`` and ``v`` are
    ``[num_layers, num_zones, zone_len, KV, head_dim]`` on ``device``, with
    one free list and one zone-table row a sequence for all layers (a
    zone id names the same zone of every layer). Its bytes and errors are
    those of per-token appends to one :class:`KVZonePool` a layer, all
    taking the same zones; :meth:`admit` and :meth:`reserve` check for
    room first and change nothing when they raise."""

    def __init__(self, *, num_layers: int, num_zones: int, zone_len: int,
                 kv_heads: int, head_dim: int, max_zones_per_seq: int,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":      # its kernels build while the caller sets up
            _build.load_in_background(paged_kernel.load, "paged_attn-load")
            _build.load_in_background(admit_kernel.load, "zone_admit-load")
        shape = (num_layers, num_zones, zone_len, kv_heads, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.num_layers = num_layers
        self._step_bufs: dict[int, torch.Tensor] = {}     # rows -> the step buffer
        self._init_zones(num_zones, zone_len, max_zones_per_seq, ("tokens_admitted",))
        self._c_admitted = self.metrics.counter("tokens_admitted")

    def admit(self, seq_id: int, k: torch.Tensor, v: torch.Tensor) -> None:
        """A new sequence holding a prompt's K/V (``[num_layers, n, KV,
        head_dim]``, any device and float dtype) in fresh zones: on the
        card one launch of the zone-admission kernel for K and V of every
        layer (a source on another device or in another dtype moved or
        cast once first), on the CPU one copy of K and one of V a zone
        run."""
        if k.dim() != 4 or k.shape != v.shape or k.shape[0] != self.num_layers:
            raise ValueError(f"need k and v of one [{self.num_layers}, n, KV, head_dim] "
                             f"shape, got {tuple(k.shape)} and {tuple(v.shape)}")
        n = k.shape[1]
        zones = -(-n // self.zone_len)
        with trace.span("kv.admit", tokens=n, zones=zones):
            if seq_id in self._seqs:
                raise KVZoneError(f"sequence {seq_id} exists")
            st = _SeqState()
            self._check_room([st], [zones])
            self._seqs[seq_id] = st
            for _ in range(zones):
                self._alloc_zone(st)
            if self.device.type == "cuda":
                k, v = (_admit_source(t, self.k) for t in (k, v))
            admit_kernel.zone_admit(self.k, self.v, k, v, st.zones)
            st.length = n
            self._c_admitted.inc(n)

    def reserve(self, seq_ids: list[int]) -> ZoneStep:
        """One decode step's slots: each row whose next slot opens a zone
        gets one, every row's length grows by its new token, and the rows'
        zones, slots, lengths, positions and zone table go to the card in
        one copy (into the step buffer of ``len(seq_ids)`` rows). The K/V of
        the new tokens come with :meth:`write`."""
        with trace.span("kv.table"):
            if len(set(seq_ids)) != len(seq_ids):
                raise ValueError("a sequence appears twice in one step")
            states = [self._seqs[sid] for sid in seq_ids]
            B, MZ, ZL = len(states), self.max_zones_per_seq, self.zone_len
            self._check_room(states, [int(st.length % ZL == 0) for st in states])
            # int32 words: zones and slots as int64 (an indexed write casts
            # an int32 index on every call), lengths, positions, the table
            buf = np.full(6 * B + B * MZ, -1, np.int32)
            index = buf[:4 * B].view(np.int64)
            table = buf[6 * B:].reshape(B, MZ)
            for i, st in enumerate(states):
                slot = st.length % ZL
                if slot == 0:
                    self._alloc_zone(st)
                st.length += 1
                index[i], index[B + i] = st.zones[-1], slot
                buf[4 * B + i], buf[5 * B + i] = st.length, st.length - 1
                table[i, :len(st.zones)] = st.zones
            self._c_tokens.inc(B)
            dev = self._step_bufs.get(B)
            if dev is None:
                dev = self._step_bufs[B] = torch.empty(buf.shape, dtype=torch.int32,
                                                       device=self.device)
            dev.copy_(host_tensor(buf))
            dev_index = dev[:4 * B].view(torch.int64)
            return ZoneStep(self, dev_index[:B], dev_index[B:], dev[4 * B:5 * B],
                            dev[5 * B:6 * B], dev[6 * B:].view(B, MZ))

    def write(self, layer: int, slots: tuple[torch.Tensor, torch.Tensor],
              k_new: torch.Tensor, v_new: torch.Tensor) -> None:
        """The step's new K/V of layer ``layer`` (``[B, KV, head_dim]``) at
        the reserved ``(zones, slots)``: one indexed write of K, one of V."""
        with trace.span("kv.append"):
            self.k[layer].index_put_(slots, k_new)
            self.v[layer].index_put_(slots, v_new)

    def attend(self, layer: int, q: torch.Tensor, table: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
        """q ``[B, H, head_dim]`` over layer ``layer``'s zones: one call of
        the paged-attention kernel on ``k[layer]``, ``v[layer]``."""
        with trace.span("kv.attend"):
            return paged_attention(q, self.k[layer], self.v[layer], table, lengths)


def _admit_source(t: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    """``t`` as the admission kernel takes it: on the pool's device in its
    dtype, each token's row dense (moved, cast or copied once where not)."""
    t = t.to(pool.device, pool.dtype)
    return t if admit_kernel.rows_dense(t) else t.contiguous()


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
