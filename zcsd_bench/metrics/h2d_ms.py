"""``h2d_ms``: the host-to-card copy of a command, in ms, the mean over the
traced slice's commands: the stats' ``h2d_seconds`` (the blocking copy of
``core/csd.py::stage_extent``)."""


def read(td):
    vals = [c.stats.h2d_seconds for c in td.commands if c.rec.ok]
    if not vals:
        return None
    v = sum(vals) / len(vals) * 1e3
    return v if v > 0 else None
