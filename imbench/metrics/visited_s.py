"""``visited_s``: the seed rounds' visited counts, summed over a job's
rounds (``single.count_visited`` or the ring's ``serial.visited_count``)."""
from imbench.metrics._stats import mean_of


def read(win):
    return mean_of(win, ("visited_s",))
