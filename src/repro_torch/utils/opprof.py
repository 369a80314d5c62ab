"""Where a profiled run's time went, op by op, from a ``torch.profiler``
profile.

Counterpart of the reference's ``utils/hloprof.py``, which sums the FLOPs
of the HLO dots by op name. This program has no dot (its work is integer
merges), so that table would be empty; the port's table shows time instead:
each op's or kernel's self time from ``key_averages()``. Where the profile
recorded CUDA activity the rows are the device's (kernels, copies and sets,
under their CUDA names: CUPTI sees the port's ctypes-launched kernels too),
else the host's self CPU time. Times are microseconds.
"""
from __future__ import annotations

from torch.autograd import DeviceType


def _device_us(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    return float(us if us is not None else evt.self_cuda_time_total)


def _on_device(evt) -> bool:
    return getattr(evt, "device_type", None) == DeviceType.CUDA


def op_profile(prof, top: int = 12):
    """``(total, [(share, value, count, name), ...])``: the ``top`` rows by
    self time (device time where CUDA activity was recorded, else CPU),
    with their share of ``total``."""
    averages = prof.key_averages()
    device = [(_device_us(e), e.count, e.key) for e in averages if _on_device(e)]
    device = [row for row in device if row[0] > 0]
    rows = device or [(float(e.self_cpu_time_total), e.count, e.key) for e in averages]
    total = sum(v for v, _, _ in rows)
    rows.sort(key=lambda r: -r[0])
    return total, [(v / total if total else 0.0, v, c, name) for v, c, name in rows[:top]]


def device_busy_us(prof) -> float:
    """Microseconds in which the card ran at least one recorded device
    event (kernel, copy or set): the union of their intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if _on_device(e))
    busy, end = 0.0, None
    for start, stop in spans:
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy


def print_profile(prof, top: int = 12) -> None:
    total, rows = op_profile(prof, top)
    clock = "device" if any(_on_device(e) for e in prof.key_averages()) else "CPU"
    print(f"total self {clock} time: {total:.4g} us")
    for share, v, c, name in rows:
        print(f"{share*100:5.1f}% {v:11.4g} x{c:<5d} {name[:72]}")
