"""``lower_s``: the single path's model lowering on the host (edge hashes,
thresholds, lt's intervals), in ``single.lower``."""
from imbench.metrics._stats import mean_of


def read(win):
    return mean_of(win, ("lower_s",))
