"""``worklists_s``: the single path's two edge orders and their work lists,
made on the device, in ``single.work_lists``."""
from imbench.metrics._stats import mean_of


def read(win):
    return mean_of(win, ("worklists_s",))
