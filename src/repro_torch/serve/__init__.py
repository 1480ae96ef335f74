"""Serving: the model's prefill and greedy decode (``step.py``), and a
zoned KV pool (``kv_zones.py``)."""
from repro_torch.serve.kv_zones import KVZoneError, KVZonePool
from repro_torch.serve.step import ServeModel, make_prefill_step, make_serve_step

__all__ = ["KVZonePool", "KVZoneError", "make_serve_step", "make_prefill_step",
           "ServeModel"]
