"""Launch and call counters of the kernels and their plain versions.

A kernel wrapper calls ``launched(name)`` where it launches its CUDA kernel,
and nowhere else; a plain version calls ``plain_called(name)`` once per
call. A run that resets both and reads ``LAUNCHES`` and ``PLAIN_CALLS``
afterwards shows which of the two carried it. The async engine launches
from two threads, so every change of a count holds one lock (``+=`` on a
``Counter`` is a read-modify-write that can lose an update).
"""
from __future__ import annotations

import threading
from collections import Counter

LAUNCHES: Counter = Counter()
PLAIN_CALLS: Counter = Counter()
_LOCK = threading.Lock()


def launched(name: str) -> None:
    with _LOCK:
        LAUNCHES[name] += 1


def plain_called(name: str) -> None:
    with _LOCK:
        PLAIN_CALLS[name] += 1


def reset() -> None:
    with _LOCK:
        LAUNCHES.clear()
        PLAIN_CALLS.clear()
