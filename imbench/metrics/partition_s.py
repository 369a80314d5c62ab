"""``partition_s``: the serial ring's partition: FASST's sample sets, the
plan and the buckets."""
from imbench.metrics._stats import mean_of


def read(win):
    return mean_of(win, ("sample_s", "plan_s", "buckets_s"))
