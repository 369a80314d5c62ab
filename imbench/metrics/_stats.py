"""The mean over the traced window's jobs of a sum of the program's own
phase timings (``InfluenceResult.stats``: host clock, each phase ending in a
device sync); nothing where a job lacks one of the keys."""


def mean_of(win, keys):
    if not win.stats or any(k not in s for s in win.stats for k in keys):
        return None
    return sum(s[k] for s in win.stats for k in keys) / len(win.stats)
