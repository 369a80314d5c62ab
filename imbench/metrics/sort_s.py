"""``sort_s``: the host sort of the edges by destination, in
``single.sort_by_dst`` or the ring's ``serial.sort_by_dst``."""
from imbench.metrics._stats import mean_of


def read(win):
    return mean_of(win, ("sort_s",))
