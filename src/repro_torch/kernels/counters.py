"""Launch and call counters of the kernels and their plain versions.

A kernel wrapper calls ``launched(name)`` where it launches its CUDA kernel,
and nowhere else; a plain version calls ``plain_called(name)`` once per
call. A run that resets both and reads ``LAUNCHES`` and ``PLAIN_CALLS``
afterwards shows which of the two carried it. A dry launch (``kernels.ops``
on a ``meta`` tensor: the dry run, which computes nothing) counts in
``DRY_LAUNCHES`` instead, with its cost from ``kernels.cost`` summed per
kernel in ``DRY_OPS`` and ``DRY_BYTES``. The async engine launches
from two threads, so every change of a count holds one lock (``+=`` on a
``Counter`` is a read-modify-write that can lose an update).
"""
from __future__ import annotations

import threading
from collections import Counter

LAUNCHES: Counter = Counter()
PLAIN_CALLS: Counter = Counter()
DRY_LAUNCHES: Counter = Counter()
DRY_OPS: Counter = Counter()
DRY_BYTES: Counter = Counter()
_LOCK = threading.Lock()


def launched(name: str) -> None:
    with _LOCK:
        LAUNCHES[name] += 1


def plain_called(name: str) -> None:
    with _LOCK:
        PLAIN_CALLS[name] += 1


def dry_launched(name: str, cost) -> None:
    """One dry launch of ``name`` and its ``(operations, bytes)``."""
    ops, nbytes = cost
    with _LOCK:
        DRY_LAUNCHES[name] += 1
        DRY_OPS[name] += int(ops)
        DRY_BYTES[name] += int(nbytes)


def reset() -> None:
    with _LOCK:
        for counts in (LAUNCHES, PLAIN_CALLS, DRY_LAUNCHES, DRY_OPS, DRY_BYTES):
            counts.clear()
