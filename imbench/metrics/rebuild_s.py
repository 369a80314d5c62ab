"""``rebuild_s``: the seed rounds' lazy rebuilds, each a fill and a propagate
fixpoint, summed over a job's rounds (``single.rebuild`` or the ring's
``serial.rebuild``)."""
from imbench.metrics._stats import mean_of


def read(win):
    return mean_of(win, ("rebuild_s",))
