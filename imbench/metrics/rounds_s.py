"""``rounds_s``: the K seed rounds (select, cascade, score, rebuilds)."""
from imbench.metrics._stats import mean_of


def read(win):
    return mean_of(win, ("rounds_s",))
