"""``paged_roofline``: the paged-attention kernel's share of its roofline,
in %: the least time of the attends the profiler saw (``bound.py`` over the
reference's ``attend_work``: one layer's K/V read once, or its logits'
operations, whichever is longer) over their device time. An attend is a
``paged_partial`` launch inside a slice command's marker with the
``paged_combine`` that follows it before the next ``paged_partial``; an
attend the profiler saw only in part is left out, not its command. ``None``
without a device trace or a reference that counts an attend's work."""
from zcsd_bench import bound

PARTIAL, COMBINE = "paged_partial", "paged_combine"


def attends(kernels):
    """``(partial, combine)`` pairs of a command's kernels, in order."""
    out, open_ = [], None
    for k in kernels:
        if PARTIAL in k[0]:
            open_ = k
        elif COMBINE in k[0] and open_ is not None:
            out.append((open_, k))
            open_ = None
    return out


def read(td):
    work = getattr(td.reference, "attend_work", None)
    if td.device is None or work is None:
        return None
    least = spent = 0.0
    for c in td.commands:
        m = td.device.markers.get(c.index)
        if m is None or not c.rec.ok:
            continue
        pairs = attends(td.device.kernels_between(*m))
        least += len(pairs) * bound.least_seconds(*work(td.config, c.command))
        spent += sum((p[3] - p[2]) + (q[3] - q[2]) for p, q in pairs)
    return 100.0 * least / spent if spent > 0 else None
