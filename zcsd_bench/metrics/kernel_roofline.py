"""``kernel_roofline``: the least time the commands' work can take on the
card (``bound.py`` over the configuration's reference's ``work``: the bytes
read and written once over 3.35 TB/s, or the operations over
67 TFLOP/s, whichever is longer), over the device time of every kernel the
profiler saw inside those commands, whatever its name, in %. Only commands
whose launches the profiler saw in full count (``TraceData.seen_in_full``).
"""


def read(td):
    full, _ = td.seen_in_full()
    if not full:
        return None
    least = sum(td.bound_seconds(c) for c, _ in full)
    spent = sum(k[3] - k[2] for _, ks in full for k in ks)
    return 100.0 * least / spent if spent > 0 else None
