"""``cascade_s``: the seed rounds' cascade fixpoints, summed over a job's
rounds (``single.cascade_fixpoint`` or the ring's ``serial.cascade_fixpoint``)."""
from imbench.metrics._stats import mean_of


def read(win):
    return mean_of(win, ("cascade_s",))
