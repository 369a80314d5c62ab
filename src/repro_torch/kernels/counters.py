"""Launch and call counters of the kernels and their plain versions.

A kernel wrapper adds one to ``LAUNCHES[name]`` where it launches its CUDA
kernel, and nowhere else; a plain version adds one to ``PLAIN_CALLS[name]``
per call. A run that resets both and reads them afterwards shows which of the
two carried it.
"""
from __future__ import annotations

from collections import Counter

LAUNCHES: Counter = Counter()
PLAIN_CALLS: Counter = Counter()


def reset() -> None:
    LAUNCHES.clear()
    PLAIN_CALLS.clear()
