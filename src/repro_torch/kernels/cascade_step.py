"""One CASCADE sweep (paper Alg. 3), Jacobi: where the predicate fires on
edge (u, v) for register j and ``M[u, j]`` is VISITED, ``out[v, j] =
VISITED``, starting from ``out = M``.

``cascade_sweep_cuda`` launches ``csrc/cascade_step.cu`` (one warp per
work item of at most ``edges.CHUNK`` edges of a destination row, then a merge
of the split rows' partials), which replaces the Pallas kernel
``src/repro/kernels/cascade_step.py`` (``cascade_sweep_pallas``).
``cascade_sweep_plain`` is its plain PyTorch version. Both return
``(out, changed)`` as the propagate sweep does.
"""
from __future__ import annotations

import torch

from repro_torch.core.sampling import PREDICATES, as_u32
from repro_torch.core.sketch import VISITED
from repro_torch.kernels import counters
from repro_torch.kernels.common import PLAIN_STEP, check_sweep, launch_item_sweep
from repro_torch.kernels.edges import EdgeOperands

NAME = "cascade_step"


def cascade_sweep_cuda(m: torch.Tensor, edges: EdgeOperands, x: torch.Tensor, *,
                       variant: int):
    check_sweep(m, edges, x)
    out, changed = launch_item_sweep(NAME, m, edges.by_dst, x, variant)
    counters.launched(NAME)
    return out, changed


def cascade_sweep_plain(m: torch.Tensor, edges: EdgeOperands, x: torch.Tensor, *,
                        variant: int):
    check_sweep(m, edges, x)
    counters.plain_called(NAME)
    pred = PREDICATES[int(variant)]
    num_regs = m.shape[1]
    xs = as_u32(x)[None, :]
    vis = m == VISITED
    acc = vis.to(torch.int32)
    step = max(1, PLAIN_STEP // max(num_regs, 1))
    for e0 in range(0, edges.num_edges, step):
        sl = slice(e0, e0 + step)
        s, d = edges.src[sl].to(torch.int64), edges.dst[sl].to(torch.int64)
        live = pred(as_u32(edges.h[sl])[:, None], as_u32(edges.lo[sl])[:, None],
                    as_u32(edges.thr[sl])[:, None], xs)
        newly = (live & vis[s]).to(torch.int32)
        acc.scatter_reduce_(0, d[:, None].expand_as(newly), newly, "amax")
    out = torch.where(acc > 0, torch.full_like(m, VISITED), m)
    return out, (out != m).any().reshape(1).to(torch.int32)
