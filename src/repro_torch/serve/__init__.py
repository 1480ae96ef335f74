"""Serving: the model's prefill and greedy decode (``step.py``), a zoned KV
pool of one layer and a zoned cache of every layer (``kv_zones.py``)."""
from repro_torch.serve.kv_zones import KVZoneCache, KVZoneError, KVZonePool, ZoneStep
from repro_torch.serve.step import ServeModel, make_prefill_step, make_serve_step

__all__ = ["KVZonePool", "KVZoneCache", "ZoneStep", "KVZoneError", "make_serve_step",
           "make_prefill_step", "ServeModel"]
