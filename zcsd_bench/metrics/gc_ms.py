"""``gc_ms``: Python's cyclic collector a command, in ms: the ``py.gc``
events' total time in the traced slice over the slice's commands. 0 when
the tracer records collections and none ran; ``None`` when it records
none (no ``trace.clock`` anchor either)."""
from zcsd_bench import spans


def read(td):
    # a tracer that records collections also anchors its clock
    if not td.commands or not any(s["name"] in (spans.CLOCK, spans.GC)
                                  for s in td.spans):
        return None
    total = sum(s["dur"] for s in td.spans if s["name"] == spans.GC)
    return total / len(td.commands) * 1e3
