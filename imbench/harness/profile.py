"""The traced window: ``torch.profiler`` (host and device activity) around
the jobs, the program's own spans (``repro_torch.obs.trace``) beside it,
and what the per-layer metrics read from both.

Each job runs inside a ``record_function("imbench.job")`` range, whose
start on the profiler's clock, against the host clock read just before it,
places the program's spans (host clock) on the profiler's timeline. Device
busy time is the union of the device's kernel, copy and set intervals (the
rule of ``repro_torch.utils.opprof.device_busy_us``, frozen here), clipped
to each job. The profiler's raw events are read directly
(``kineto_results``), which costs far less than building its event tree.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

JOB = "imbench.job"
#: the longest name an operation keeps in the breakdown
NAME_CHARS = 120
#: what names a gap in which no span of the program was open
NO_SPAN = "outside the program's spans"
TOP = 10


@dataclasses.dataclass
class Reading:
    """Per job, the device's busy seconds; over the traced window, its busy
    and total seconds, the device operations that took most time and the
    longest idle gaps with the program's span open at each."""

    job_busy_s: List[float]
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _ns(evt) -> Tuple[int, int]:
    return evt.start_ns(), evt.end_ns()


def short_name(name: str) -> str:
    """A device operation's name without its parameter list, cut to
    ``NAME_CHARS``."""
    depth = 0
    for i, ch in enumerate(name):
        depth += ch in "<["
        depth -= ch in ">]"
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:NAME_CHARS]


def _is_annotation(evt) -> bool:
    """A ``record_function`` range, which the profiler also draws on the
    device's timeline; it is no device work."""
    return evt.name() == JOB or evt.is_user_annotation()


def _union(spans: np.ndarray) -> np.ndarray:
    """Sorted, disjoint intervals covering ``spans`` (an [n, 2] array)."""
    if not len(spans):
        return spans.reshape(0, 2)
    spans = spans[np.argsort(spans[:, 0], kind="stable")]
    reach = np.maximum.accumulate(spans[:, 1])
    new = np.concatenate([[True], spans[1:, 0] > reach[:-1]])
    starts = spans[new, 0]
    ends = reach[np.concatenate([np.flatnonzero(new)[1:] - 1, [len(spans) - 1]])]
    return np.stack([starts, ends], axis=1)


def _busy(merged: np.ndarray, lo: int, hi: int) -> int:
    return int(np.clip(np.minimum(merged[:, 1], hi) - np.maximum(merged[:, 0], lo), 0,
                       None).sum())


class Tracer:
    """Profiles the jobs run under ``job()``, between ``start()`` and
    ``stop()``, and records the program's spans meanwhile."""

    def __init__(self, device: torch.device):
        self.device = device
        self.job_py: List[Tuple[float, float]] = []
        self.spans: List[Tuple[str, int, float, float]] = []
        self._prof = None

    def _on_span(self, sp) -> None:
        self.spans.append((sp.name, sp.depth, sp.t0, sp.t1))

    def start(self) -> None:
        from repro_torch.obs import trace
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        trace.get_recorder().start()
        trace.add_span_listener(self._on_span)
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def stop(self) -> None:
        from repro_torch.obs import trace

        with warnings.catch_warnings():
            # torch warns that one profiling cycle's events are all it keeps
            warnings.simplefilter("ignore", UserWarning)
            self._prof.__exit__(None, None, None)
        trace.remove_span_listener(self._on_span)
        trace.get_recorder().stop()
        trace.get_recorder().clear()

    @contextlib.contextmanager
    def job(self):
        t0 = time.perf_counter()
        with torch.profiler.record_function(JOB):
            yield
        self.job_py.append((t0, time.perf_counter()))

    def read(self) -> Reading:
        from torch.autograd import DeviceType

        jobs, device, names = [], [], []
        for evt in self._prof.profiler.kineto_results.events():
            on_device = evt.device_type() == DeviceType.CUDA
            if evt.name() == JOB and not on_device:
                jobs.append(_ns(evt))
            elif on_device and not _is_annotation(evt):
                device.append(_ns(evt))
                names.append(short_name(evt.name()))
        jobs.sort()
        if len(jobs) != len(self.job_py):
            raise RuntimeError(f"the profiler saw {len(jobs)} jobs, the harness ran "
                               f"{len(self.job_py)}")
        spans = np.asarray(device, dtype=np.int64).reshape(-1, 2)
        merged = _union(spans)
        lo, hi = jobs[0][0], jobs[-1][1]
        job_busy = [_busy(merged, a, b) * 1e-9 for a, b in jobs]
        inside = (spans[:, 1] > lo) & (spans[:, 0] < hi)
        totals: dict = {}
        for (a, b), name, keep in zip(device, names, inside):
            if keep:
                totals[name] = totals.get(name, 0) + (b - a)
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
        return Reading(job_busy_s=job_busy, busy_s=_busy(merged, lo, hi) * 1e-9,
                       window_s=(hi - lo) * 1e-9,
                       device_ops=[(name, ns * 1e-9) for name, ns in ops],
                       idle_gaps=self._gaps(merged, jobs))

    def _gaps(self, merged: np.ndarray, jobs) -> List[Tuple[str, float]]:
        """The longest idle stretches of the window, each named by the
        innermost span of the program open at its middle."""
        lo, hi = jobs[0][0], jobs[-1][1]
        clipped = merged[(merged[:, 1] > lo) & (merged[:, 0] < hi)]
        edges = np.concatenate([[lo], clipped.reshape(-1), [hi]]).reshape(-1, 2)
        length = np.clip(edges[:, 1] - edges[:, 0], 0, None)
        out = []
        for i in np.argsort(-length, kind="stable")[:TOP]:
            if length[i] <= 0:
                break
            mid = (edges[i, 0] + edges[i, 1]) // 2
            out.append((self._span_at(mid, jobs), float(length[i]) * 1e-9))
        return out

    def _span_at(self, t_ns: int, jobs) -> str:
        job = next((j for j, (a, b) in enumerate(jobs) if a <= t_ns <= b), None)
        if job is None:
            return "between jobs"
        offset = jobs[job][0] - self.job_py[job][0] * 1e9
        best: Optional[Tuple[int, str]] = None
        for name, depth, t0, t1 in self.spans:
            if t0 * 1e9 + offset <= t_ns <= t1 * 1e9 + offset and (
                    best is None or depth > best[0]):
                best = (depth, name)
        return best[1] if best else NO_SPAN
