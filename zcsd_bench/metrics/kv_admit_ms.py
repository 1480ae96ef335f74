"""``kv_admit_ms``: the zoned cache's admissions and evictions a command, in
ms: the mean over the traced slice's completed commands of their
``kv.admit`` and ``kv.evict`` spans (``KVZoneCache.admit``: a prompt's K/V
copied into fresh zones, every layer at once; ``evict``: the zones reset
to the free list)."""
from zcsd_bench import spans


def read(td):
    admit, evict = spans.mean_of(td, "kv.admit"), spans.mean_of(td, "kv.evict")
    if admit is None and evict is None:
        return None
    return ((admit or 0.0) + (evict or 0.0)) * 1e3
