"""``sort_s``: the sort of the edges by destination: on the job's device in
``single.sort_by_dst`` and the ring's ``serial.sort_by_dst``, on the host
(``Graph.sorted_by_dst()`` without a device) on each rank of the mesh."""
from imbench.metrics._stats import mean_of


def read(win):
    return mean_of(win, ("sort_s",))
