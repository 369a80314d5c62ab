"""``prep_s``: a job's host preparation. The single path's ``prep_s`` (dst
sort, model lowering, work lists, upload); the serial ring's sort, sample
sets, plan, buckets and ring state."""
from imbench.metrics._stats import mean_of

SERIAL = ("sort_s", "sample_s", "plan_s", "buckets_s", "state_s")


def read(win):
    single = mean_of(win, ("prep_s",))
    return single if single is not None else mean_of(win, SERIAL)
