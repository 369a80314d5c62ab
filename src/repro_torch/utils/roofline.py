"""The H100's published roofs and the bandwidth attribution of a span.

Counterpart of the reference's ``utils/roofline.py``, of which only
``annotate_bandwidth`` is ported; its dry-run ``Roofline`` waits for the
port's dry run. The roofs are the data sheet's for the card the port
targets, an NVIDIA H100 SXM5 80GB: device memory 3.35 TB/s, and INT32
132 SMs x 64 lanes x 1.98 GHz, about 16.7 T operations per second.
"""
from __future__ import annotations

#: the card the roofs below belong to
CARD = "NVIDIA H100 SXM5 80GB"
HBM_BW = 3.35e12          # B/s, device memory
INT32_OPS = 16.7e12       # INT32 operations per second


def annotate_bandwidth(sp, nbytes: int, seconds: float) -> float:
    """Attach the achieved GB/s and its fraction of :data:`HBM_BW` to a trace
    span. ``sp`` may be the null span (tracing off): ``annotate`` is then a
    no-op and only the returned GB/s means anything. Returns 0.0 for a
    degenerate timing instead of raising."""
    if seconds <= 0 or nbytes <= 0:
        return 0.0
    gbps = nbytes / seconds / 1e9
    sp.annotate(achieved_gbps=round(gbps, 3), frac_of_roof=round(gbps * 1e9 / HBM_BW, 6))
    return gbps
