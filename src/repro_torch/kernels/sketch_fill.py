"""FILL-SKETCHES (paper Alg. 1): ``M[r, j] = clz(register_hash(u, j +
reg_offset, seed))`` as int8, VISITED entries kept. Row r holds vertex
``u = r``, or ``u = ids[r]`` where a row-id operand ``ids`` (int32 or int64,
``[n_rows]``) is given: a mesh rank fills the rows it owns by their original
vertex ids, and ``core.sketch.fill_registers`` any id list.

``sketch_fill_cuda`` launches ``csrc/sketch_fill.cu``, which replaces the
Pallas kernel ``src/repro/kernels/sketch_fill.py`` (``sketch_fill_pallas``).
``sketch_fill_plain`` is its plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sampling import MASK32, t_clz32, t_register_hash
from repro_torch.core.sketch import VISITED
from repro_torch.kernels import build, counters
from repro_torch.kernels.common import PLAIN_STEP, check_cuda, check_matrix, stream

NAME = "sketch_fill"


def check_ids(ids: Optional[torch.Tensor], m: torch.Tensor) -> None:
    """``ids``: None, or a contiguous int32 or int64 ``[n_rows]`` tensor on
    ``m``'s device."""
    if ids is None:
        return
    if (not isinstance(ids, torch.Tensor) or ids.dtype not in (torch.int32, torch.int64)
            or tuple(ids.shape) != (m.shape[0],) or not ids.is_contiguous()):
        raise ValueError(f"ids must be a contiguous int32 or int64 [{m.shape[0]}] tensor, "
                         f"got {getattr(ids, 'dtype', type(ids))} "
                         f"{tuple(getattr(ids, 'shape', ()))}")
    if ids.device != m.device:
        raise ValueError(f"ids are on {ids.device}, the matrix on {m.device}")


def sketch_fill_cuda(m: torch.Tensor, *, ids: Optional[torch.Tensor] = None,
                     reg_offset: int = 0, seed: int = 0) -> torch.Tensor:
    check_matrix(m)
    check_ids(ids, m)
    dev = check_cuda(m)
    out = torch.empty_like(m)
    n, j = m.shape
    fn = build.load(NAME)
    ids_ptr, id_bytes = (None, 0) if ids is None else (ids.data_ptr(), ids.element_size())
    build.check(NAME, fn(m.data_ptr(), out.data_ptr(), ids_ptr, id_bytes, n, j,
                         reg_offset & MASK32, seed & MASK32, stream(dev)))
    counters.launched(NAME)
    return out


def sketch_fill_plain(m: torch.Tensor, *, ids: Optional[torch.Tensor] = None,
                      reg_offset: int = 0, seed: int = 0) -> torch.Tensor:
    check_matrix(m)
    check_ids(ids, m)
    counters.plain_called(NAME)
    n, num_regs = m.shape
    j = ((torch.arange(num_regs, dtype=torch.int64, device=m.device) + reg_offset)
         & MASK32)[None, :]
    out = torch.empty_like(m)
    step = max(1, PLAIN_STEP // max(num_regs, 1))
    for r0 in range(0, n, step):
        if ids is None:
            u = torch.arange(r0, min(r0 + step, n), dtype=torch.int64, device=m.device)
        else:
            u = ids[r0:r0 + step].to(torch.int64) & MASK32
        fresh = t_clz32(t_register_hash(u[:, None], j, seed)).to(torch.int8)
        blk = m[r0:r0 + step]
        out[r0:r0 + step] = torch.where(blk == VISITED, blk, fresh)
    return out
