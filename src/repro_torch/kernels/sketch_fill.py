"""FILL-SKETCHES (paper Alg. 1): ``M[u, j] = clz(register_hash(u, j +
reg_offset, seed))`` as int8, VISITED entries kept.

``sketch_fill_cuda`` launches ``csrc/sketch_fill.cu``, which replaces the
Pallas kernel ``src/repro/kernels/sketch_fill.py`` (``sketch_fill_pallas``).
``sketch_fill_plain`` is its plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.core.sampling import MASK32, t_clz32, t_register_hash
from repro_torch.core.sketch import VISITED
from repro_torch.kernels import build, counters
from repro_torch.kernels.common import PLAIN_STEP, check_cuda, check_matrix, stream

NAME = "sketch_fill"


def sketch_fill_cuda(m: torch.Tensor, *, reg_offset: int = 0, seed: int = 0) -> torch.Tensor:
    check_matrix(m)
    dev = check_cuda(m)
    out = torch.empty_like(m)
    n, j = m.shape
    fn = build.load(NAME)
    build.check(NAME, fn(m.data_ptr(), out.data_ptr(), n, j, reg_offset & MASK32,
                         seed & MASK32, stream(dev)))
    counters.launched(NAME)
    return out


def sketch_fill_plain(m: torch.Tensor, *, reg_offset: int = 0, seed: int = 0) -> torch.Tensor:
    check_matrix(m)
    counters.plain_called(NAME)
    n, num_regs = m.shape
    j = ((torch.arange(num_regs, dtype=torch.int64, device=m.device) + reg_offset)
         & MASK32)[None, :]
    out = torch.empty_like(m)
    step = max(1, PLAIN_STEP // max(num_regs, 1))
    for r0 in range(0, n, step):
        u = torch.arange(r0, min(r0 + step, n), dtype=torch.int64, device=m.device)[:, None]
        fresh = t_clz32(t_register_hash(u, j, seed)).to(torch.int8)
        blk = m[r0:r0 + step]
        out[r0:r0 + step] = torch.where(blk == VISITED, blk, fresh)
    return out
