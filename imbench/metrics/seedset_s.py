"""``seedset_s``: the window's wall time over the jobs it completed (host
clock, each job ending in a device sync)."""


def read(win):
    return win.seconds / len(win.jobs)
