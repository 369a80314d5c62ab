"""``upload_s``: the single path's copies of the five edge operands and x
to the device, in ``single.upload``."""
from imbench.metrics._stats import mean_of


def read(win):
    return mean_of(win, ("upload_s",))
