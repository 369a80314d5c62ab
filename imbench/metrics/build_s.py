"""``build_s``: the fill and the build's propagate sweeps to the fixpoint."""
from imbench.metrics._stats import mean_of


def read(win):
    return mean_of(win, ("build_s",))
