"""One SIMULATE sweep (paper Alg. 2), Jacobi: where the predicate fires on
edge (u, v) for register j, ``out[u, j] = max(out[u, j], M[v, j])``,
starting from ``out = M``; VISITED entries of M stay VISITED.

``propagate_sweep_cuda`` launches ``csrc/sketch_propagate.cu`` (one warp per
work item of at most ``edges.CHUNK`` edges of a source row, then a merge of
the split rows' partials), which replaces the Pallas kernel
``src/repro/kernels/sketch_propagate.py`` (``propagate_sweep_pallas``).
``propagate_sweep_plain`` is its plain PyTorch version over the serving-order
edges. Both return ``(out, changed)``: ``changed`` is a one-element tensor on
the device, nonzero when ``out`` differs from ``M``.
"""
from __future__ import annotations

import torch

from repro_torch.core.sampling import PREDICATES, as_u32
from repro_torch.core.sketch import VISITED
from repro_torch.kernels import counters
from repro_torch.kernels.common import PLAIN_STEP, check_sweep, launch_item_sweep
from repro_torch.kernels.edges import EdgeOperands

NAME = "sketch_propagate"


def propagate_sweep_cuda(m: torch.Tensor, edges: EdgeOperands, x: torch.Tensor, *,
                         variant: int):
    check_sweep(m, edges, x)
    out, changed = launch_item_sweep(NAME, m, edges.by_src, x, variant)
    counters.launched(NAME)
    return out, changed


def propagate_sweep_plain(m: torch.Tensor, edges: EdgeOperands, x: torch.Tensor, *,
                          variant: int):
    check_sweep(m, edges, x)
    counters.plain_called(NAME)
    pred = PREDICATES[int(variant)]
    num_regs = m.shape[1]
    xs = as_u32(x)[None, :]
    acc = m.to(torch.int32)
    step = max(1, PLAIN_STEP // max(num_regs, 1))
    for e0 in range(0, edges.num_edges, step):
        sl = slice(e0, e0 + step)
        s, d = edges.src[sl].to(torch.int64), edges.dst[sl].to(torch.int64)
        live = pred(as_u32(edges.h[sl])[:, None], as_u32(edges.lo[sl])[:, None],
                    as_u32(edges.thr[sl])[:, None], xs)
        contrib = torch.where(live, m[d].to(torch.int32), VISITED)
        acc.scatter_reduce_(0, s[:, None].expand_as(contrib), contrib, "amax")
    out = torch.where(m == VISITED, m, acc.to(torch.int8))
    return out, (out != m).any().reshape(1).to(torch.int32)
