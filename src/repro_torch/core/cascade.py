"""Influence cascade (paper §3.3, Alg. 3 and Alg. 4 lines 15-19).

Counterpart of the reference's ``core/cascade.py`` ``cascade_from_seed``:
mark the seed's row VISITED, then close the visited set under sampled edges
with cascade sweeps, under the same loop rule as the propagate fixpoint.
"""
from __future__ import annotations

import torch

from repro_torch.core.sketch import VISITED
from repro_torch.kernels import ops
from repro_torch.kernels.edges import EdgeOperands


def cascade_from_seed(m: torch.Tensor, seed_vertex: int, edges: EdgeOperands,
                      x: torch.Tensor, *, variant: int, max_iters: int = 64):
    """Returns ``(m, iters)``; the input ``m`` is left as it was."""
    m = m.clone()
    m[seed_vertex] = VISITED
    iters, changed = 0, True
    while changed and iters < max_iters:
        m, flag = ops.cascade_sweep(m, edges, x, variant=variant)
        changed = bool(flag.item())
        iters += 1
    return m, iters
