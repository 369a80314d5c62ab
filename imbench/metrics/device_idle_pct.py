"""``device_idle_pct``: the share of the traced jobs' wall time in which no
operation ran on the device (the union of the profiler's kernel, copy and
set intervals). Nothing where the profile holds no device activity."""


def read(win):
    r = win.reading
    if r is None or r.busy_s <= 0 or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
