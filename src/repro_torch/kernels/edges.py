"""Edge operands on the device, in the two orders the sweeps need.

The serving order (``core.difuser.normalize_inputs``) sorts edges by
destination. The cascade sweep writes destination rows, so that order gives
each row one owner. The propagate sweep writes source rows, and CUDA has no
8-bit atomic max, so it gets a source-ordered copy. Both are made once per
build, on the operands' device, as compressed rows: ``rowptr[r]:rowptr[r+1]``
are row r's edges, ``nbr`` the other endpoint of each.

``h``, ``lo``, ``thr`` (and ``x``) are uint32 values stored as int32 bit
patterns, which every PyTorch indexing operation supports; the kernels read
them as ``uint32_t`` and the plain versions through ``core.sampling.as_u32``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EdgeRows:
    """Edges grouped by the row a sweep writes."""

    rowptr: torch.Tensor  # int32[n_pad + 1]
    nbr: torch.Tensor     # int32[E], the row each edge reads
    h: torch.Tensor       # int32[E] (uint32 bits)
    lo: torch.Tensor
    thr: torch.Tensor


@dataclasses.dataclass(frozen=True)
class EdgeOperands:
    """``(src, dst, h, lo, thr)`` in serving order plus both row layouts."""

    n_pad: int
    src: torch.Tensor
    dst: torch.Tensor
    h: torch.Tensor
    lo: torch.Tensor
    thr: torch.Tensor
    by_src: EdgeRows      # propagate: a source row and its out-edges
    by_dst: EdgeRows      # cascade: a destination row and its in-edges

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @staticmethod
    def from_numpy(src, dst, h, lo, thr, n_pad: int, device) -> "EdgeOperands":
        """Upload numpy operands (int32 ids, uint32 ``h``/``lo``/``thr``)."""
        def ids(a):
            return torch.from_numpy(np.require(a, np.int32, ["C", "W"])).to(device)

        def bits(a):
            a = np.require(a, np.uint32, ["C", "W"]).view(np.int32)
            return torch.from_numpy(a).to(device)

        src, dst = ids(src), ids(dst)
        if src.numel() >= 2**31:
            raise ValueError("edge count must stay below 2^31 (int32 row pointers)")
        h, lo, thr = bits(h), bits(lo), bits(thr)
        return EdgeOperands(n_pad=int(n_pad), src=src, dst=dst, h=h, lo=lo, thr=thr,
                            by_src=group_rows(src, dst, h, lo, thr, n_pad),
                            by_dst=group_rows(dst, src, h, lo, thr, n_pad))


def group_rows(key, nbr, h, lo, thr, n_rows: int) -> EdgeRows:
    """Group edges by ``key`` (the row a sweep writes, in ``[0, n_rows)``),
    keeping their order within a row."""
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key.to(torch.int64), minlength=n_rows)
    rowptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=key.device)
    rowptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return EdgeRows(rowptr=rowptr, nbr=nbr[order].contiguous(),
                    h=h[order].contiguous(), lo=lo[order].contiguous(),
                    thr=thr[order].contiguous())


def row_ids(rows: EdgeRows) -> torch.Tensor:
    """int64 write row of each grouped edge (the plain versions scatter by it)."""
    n_rows = rows.rowptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n_rows, device=rows.rowptr.device),
                                   torch.diff(rows.rowptr).to(torch.int64))
