"""Serving over a zoned KV pool. The port of ``repro.serve``'s
``kv_zones``; the model-driven decode step (``serve/step.py``) is not
ported yet."""
from repro_torch.serve.kv_zones import KVZoneError, KVZonePool

__all__ = ["KVZonePool", "KVZoneError"]
