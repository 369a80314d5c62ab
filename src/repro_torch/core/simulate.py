"""Sketch propagation to a fixpoint (paper Alg. 2 and Alg. 4 lines 5-6).

Counterpart of the reference's ``core/simulate.py`` ``propagate_to_fixpoint``,
as a Python loop: every sweep counts, the last one (which changes nothing)
too, and the loop stops at ``max_iters``. The host reads the sweep's
one-element changed flag once per sweep.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.edges import EdgeOperands


def propagate_to_fixpoint(m: torch.Tensor, edges: EdgeOperands, x: torch.Tensor, *,
                          variant: int, max_iters: int = 64):
    """Run propagate sweeps until nothing changes. Returns ``(m, iters)``."""
    iters, changed = 0, True
    while changed and iters < max_iters:
        m, flag = ops.propagate_sweep(m, edges, x, variant=variant)
        changed = bool(flag.item())
        iters += 1
    return m, iters
