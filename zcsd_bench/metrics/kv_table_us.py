"""``kv_table_us``: a step's reservation in the zoned cache, in us: the mean
over the traced slice's completed commands of their ``kv.table`` spans
(``KVZoneCache.reserve``: zones taken for rows that fill theirs, the zone
table, lengths and slots built and copied to the card once)."""
from zcsd_bench import spans


def read(td):
    v = spans.mean_of(td, "kv.table")
    return None if v is None else v * 1e6
