"""Shared cache of compiled offload executables.

The paper reports "JIT time" as a first-class offload statistic because
compilation is the dominant fixed cost of a fresh offload. Before this module
every consumer kept its own ad-hoc dict — one per :class:`~repro_torch.core.csd.NvmCsd`,
two per :class:`~repro_torch.array.scheduler.OffloadScheduler` (single + vmapped) and
nothing at all for the Pallas tier, which re-traced on every call. The
:class:`CompiledProgramCache` promotes them into one bounded, thread-safe LRU
keyed by ``(tier kind, program, geometry)``:

  * programs are frozen dataclasses, so the program itself is the signature;
  * geometry (pages, elements per page, chunk batch) pins the compiled shape;
  * the tier kind ("jit" / "jit_batched" / "kernel" / "kernel_batched")
    separates executables with identical shapes but different backends.

Builds are compile-once per key but do NOT hold the cache-wide lock: the
first thread to miss a key builds it while only same-key racers wait (they
block on a per-key event and then count as hits with zero compile time —
nobody double-counts ``jit_seconds``); lookups for other keys proceed
untouched, so one multi-second XLA compile cannot stall every device worker
sharing the process-wide cache. Hit/miss/eviction counts are host-visible
(surfaced per-offload in ``OffloadStats`` and in aggregate via
:meth:`CompiledProgramCache.stats`).
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Hashable, Optional, Tuple

from repro_torch.telemetry.metrics import registry as _registry

__all__ = ["CompiledProgramCache", "CacheStats", "default_cache",
           "DEFAULT_CACHE_CAPACITY"]

DEFAULT_CACHE_CAPACITY = 128


@dataclass(frozen=True)
class CacheStats:
    """Point-in-time cache counters (cumulative since construction)."""

    hits: int
    misses: int
    evictions: int
    size: int
    capacity: int

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclass
class _Build:
    """Rendezvous for threads racing on one uncompiled key."""

    done: threading.Event = field(default_factory=threading.Event)
    entry: object = None


class CompiledProgramCache:
    """Bounded, thread-safe LRU of compiled offload executables."""

    # every live cache, so ONE metrics collector can aggregate them all
    # (weak: a dropped cache must not be pinned by its own telemetry)
    _instances: "weakref.WeakSet[CompiledProgramCache]" = weakref.WeakSet()
    _instances_lock = threading.Lock()

    def __init__(self, capacity: int = DEFAULT_CACHE_CAPACITY):
        if capacity <= 0:
            raise ValueError("cache capacity must be positive")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: OrderedDict[Hashable, object] = OrderedDict()
        self._building: dict[Hashable, _Build] = {}
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        with CompiledProgramCache._instances_lock:
            CompiledProgramCache._instances.add(self)

    def get_or_build(self, key: Hashable,
                     builder: Callable[[], object]) -> Tuple[object, float, bool]:
        """Return ``(executable, compile_seconds, hit)`` for ``key``.

        ``compile_seconds`` is 0.0 on a hit; on a miss ``builder()`` runs
        OUTSIDE the cache lock (lookups for other keys proceed during the
        compile) while same-key racers wait and then report a hit. ``builder``
        must return an object with a ``compile_seconds`` attribute (e.g.
        :class:`~repro_torch.core.vm.JittedProgram`). If a build fails, its waiters
        retry (one of them becomes the next builder).
        """
        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    self._entries.move_to_end(key)
                    self._hits += 1
                    return entry, 0.0, True
                build = self._building.get(key)
                am_builder = build is None
                if am_builder:
                    build = _Build()
                    self._building[key] = build
            if am_builder:
                try:
                    entry = builder()
                except BaseException:
                    with self._lock:
                        self._building.pop(key, None)
                    build.done.set()     # waiters retry (entry stays None)
                    raise
                with self._lock:
                    self._misses += 1
                    self._entries[key] = entry
                    while len(self._entries) > self.capacity:
                        self._entries.popitem(last=False)
                        self._evictions += 1
                    self._building.pop(key, None)
                build.entry = entry
                build.done.set()
                return entry, float(getattr(entry, "compile_seconds", 0.0)), False
            build.done.wait()
            if build.entry is not None:
                with self._lock:
                    self._hits += 1
                return build.entry, 0.0, True
            # builder failed: loop; one waiter becomes the next builder

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(self._hits, self._misses, self._evictions,
                              len(self._entries), self.capacity)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


def _collect_cache_stats() -> dict:
    """Aggregate hit/miss/eviction/size over every LIVE compile cache — the
    ``compile_cache.*`` series of the global metrics snapshot (the ISSUE's
    "one snapshot shows the whole offload picture")."""
    hits = misses = evictions = size = 0
    with CompiledProgramCache._instances_lock:
        caches = list(CompiledProgramCache._instances)
    for c in caches:
        s = c.stats()
        hits += s.hits
        misses += s.misses
        evictions += s.evictions
        size += s.size
    total = hits + misses
    return {
        "hits": hits,
        "misses": misses,
        "evictions": evictions,
        "size": size,
        "hit_rate": hits / total if total else 0.0,
        "live_caches": len(caches),
    }


_registry().register_collector("compile_cache", _collect_cache_stats)

_default: Optional[CompiledProgramCache] = None
_default_lock = threading.Lock()


def default_cache() -> CompiledProgramCache:
    """The process-wide cache: pass it to every ``NvmCsd``/``OffloadScheduler``
    that should share compiled executables (the multi-device deployment
    default — programs are device-agnostic, so reuse is maximal)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = CompiledProgramCache()
        return _default
