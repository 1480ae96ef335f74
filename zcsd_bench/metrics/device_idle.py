"""``device_idle``: the share of the traced slice in which the card runs no
kernel, copy or memset (the union of the profiler's device intervals), in
%."""


def read(td):
    if td.device is None:
        return None
    lo, hi = td.device.window
    busy = sum(b - a for a, b in td.busy_intervals())
    return 100.0 * (1.0 - busy / (hi - lo)) if hi > lo else None
