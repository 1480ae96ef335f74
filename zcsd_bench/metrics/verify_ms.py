"""``verify_ms``: the verifier's time a command (``core/verifier.py``, timed
by ``NvmCsd.nvm_cmd_bpf_run`` as ``OffloadStats.verify_seconds``), in ms,
the mean over the traced slice's commands."""


def read(td):
    vals = [c.stats.verify_seconds for c in td.commands if c.rec.ok]
    if not vals:
        return None
    v = sum(vals) / len(vals) * 1e3
    return v if v > 0 else None
