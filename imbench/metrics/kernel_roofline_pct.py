"""``kernel_roofline_pct``: the least time Alg. 4's work needs on the card
(``harness.cost``: the jobs' fills, propagate and cascade sweeps and
cardinality passes, from their own counts, at the graph's real n and m)
over all device busy time inside the traced jobs, whatever ran. It reads
the work, not which kernels did it. Single-device jobs only: the serial
ring's work has other shapes. Nothing without device activity."""
from imbench.harness import cost


def read(win):
    r = win.reading
    if r is None or win.backend != "single" or sum(r.job_busy_s) <= 0:
        return None
    bound = sum(cost.job_bound_s(win.n, win.num_registers, win.m, win.model, k=win.k,
                                 rebuilds=int(job.rebuilds.sum()),
                                 propagate_sweeps=job.build_sweeps + job.rebuild_sweeps,
                                 cascade_sweeps=job.cascade_sweeps)
                for job in win.jobs)
    return 100.0 * bound / sum(r.job_busy_s)
