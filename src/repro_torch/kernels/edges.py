"""Edge operands on the device, in the two orders the sweeps need.

The serving order (``core.difuser.normalize_inputs``) sorts edges by
destination. The cascade sweep writes destination rows and the propagate
sweep source rows; CUDA has no 8-bit atomic max, so each sweep gets its edges
grouped by the row it writes. Both orders are made once per build, on the
operands' device, as compressed rows: ``rowptr[r]:rowptr[r+1]`` are row r's
edges, ``nbr`` the other endpoint of each.

R-MAT rows are skewed (at rmat:20 one row has about 40,000 edges, half of
all rows none), so the sweep kernels do not take a row as their unit of work
but an item of the ``WorkList`` (``work_list``): a row of at most
``item_edges`` edges (``CHUNK`` by default) is one item, a longer row is cut
into items of ``item_edges`` edges whose partial results a second pass
merges. No item is longer than ``item_edges``, so no row sets the length of
a sweep. A work list also names the block shape its sweep kernels launch
with, ``item_warps`` warps (items) a block: ``kernels.build`` compiles the
single path's sweeps once per shape in ``ITEM_WARPS``. Neither knob changes
a result (max and OR merges do not depend on how a row's edges are cut or
scheduled); ``repro_torch.tune`` measures them.

``h``, ``lo``, ``thr`` (and ``x``) are uint32 values stored as int32 bit
patterns, which every PyTorch indexing operation supports; the kernels read
them as ``uint32_t`` and the plain versions through ``core.sampling.as_u32``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


#: the default most edges of one work item; a longer row is split
CHUNK = 256
#: the default warps (items) of one block of the work-item kernels
ITEM_WARPS = 4


@dataclasses.dataclass(frozen=True)
class ItemGeometry:
    """How a sweep's rows are cut and launched: items of at most ``edges``
    edges, ``warps`` items a block. The defaults are ``CHUNK`` and
    ``ITEM_WARPS``."""

    edges: int = CHUNK
    warps: int = ITEM_WARPS

    def __post_init__(self):
        if int(self.edges) < 1 or int(self.warps) < 1:
            raise ValueError(f"item geometry needs edges and warps >= 1, got {self}")


DEFAULT_GEOMETRY = ItemGeometry()


@dataclasses.dataclass(frozen=True)
class WorkList:
    """The edges of grouped rows cut into items of at most ``item_edges``
    edges, for kernels that launch ``item_warps`` items a block.

    Items follow the rows in order and cover the edges in order: item i is
    the edges ``item_ptr[i]:item_ptr[i+1]`` of row ``item_row[i]``. A row of
    at most ``item_edges`` edges, an empty row too, is one item; a row of
    ``d`` edges above that is ``ceil(d / item_edges)`` items.
    ``item_slot[i]`` is -1 for an item that is its whole row, else the item's
    own partial slot. The split rows are ``split_row``; split row k owns the
    consecutive slots ``split_ptr[k]:split_ptr[k+1]``.
    """

    item_ptr: torch.Tensor   # int32[num_items + 1]
    item_row: torch.Tensor   # int32[num_items]
    item_slot: torch.Tensor  # int32[num_items]
    split_row: torch.Tensor  # int32[num_split]
    split_ptr: torch.Tensor  # int32[num_split + 1]
    num_partials: int
    item_edges: int = CHUNK
    item_warps: int = ITEM_WARPS

    @property
    def num_items(self) -> int:
        return int(self.item_row.shape[0])

    @property
    def num_split(self) -> int:
        return int(self.split_row.shape[0])


@dataclasses.dataclass(frozen=True)
class EdgeRows:
    """Edges grouped by the row a sweep writes, with their work list where
    a sweep kernel takes it (``with_work``)."""

    rowptr: torch.Tensor  # int32[n_pad + 1]
    nbr: torch.Tensor     # int32[E], the row each edge reads
    h: torch.Tensor       # int32[E] (uint32 bits)
    lo: torch.Tensor
    thr: torch.Tensor
    work: Optional[WorkList] = None


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
    def from_numpy(src, dst, h, lo, thr, n_pad: int, device, *,
                   propagate: ItemGeometry = DEFAULT_GEOMETRY,
                   cascade: ItemGeometry = DEFAULT_GEOMETRY) -> "EdgeOperands":
        """Upload numpy operands (int32 ids, uint32 ``h``/``lo``/``thr``);
        ``propagate`` and ``cascade`` are the work lists' geometry of
        ``by_src`` and ``by_dst``. ``upload`` then ``from_device``."""
        return EdgeOperands.from_device(*upload(src, dst, h, lo, thr, device), n_pad,
                                        propagate=propagate, cascade=cascade)

    @staticmethod
    def from_device(src, dst, h, lo, thr, n_pad: int, *,
                    propagate: ItemGeometry = DEFAULT_GEOMETRY,
                    cascade: ItemGeometry = DEFAULT_GEOMETRY) -> "EdgeOperands":
        """Both row layouts and their work lists from operands already on
        the device (``upload``'s), on that device."""
        return EdgeOperands(n_pad=int(n_pad), src=src, dst=dst, h=h, lo=lo, thr=thr,
                            by_src=with_work(group_rows(src, dst, h, lo, thr, n_pad),
                                             item_edges=propagate.edges,
                                             item_warps=propagate.warps),
                            by_dst=with_work(group_rows(dst, src, h, lo, thr, n_pad),
                                             item_edges=cascade.edges,
                                             item_warps=cascade.warps))


def upload(src, dst, h, lo, thr, device):
    """The five numpy operands on ``device``, as ``(src, dst, h, lo, thr)``
    int32 tensors (``h``/``lo``/``thr`` holding the uint32 bits)."""
    def ids(a):
        return torch.from_numpy(np.require(a, np.int32, ["C", "W"])).to(device)

    def bits(a):
        a = np.require(a, np.uint32, ["C", "W"]).view(np.int32)
        return torch.from_numpy(a).to(device)

    if np.shape(src)[0] >= 2**31:
        raise ValueError("edge count must stay below 2^31 (int32 row pointers)")
    return ids(src), ids(dst), bits(h), bits(lo), bits(thr)


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


def work_list(rowptr: torch.Tensor, item_edges: int = CHUNK,
              item_warps: int = ITEM_WARPS) -> WorkList:
    """Cut the rows of ``rowptr`` into items of at most ``item_edges`` edges,
    on ``rowptr``'s device, for kernels of ``item_warps`` warps a block (see
    ``WorkList``)."""
    geometry = ItemGeometry(int(item_edges), int(item_warps))   # checks both
    chunk = geometry.edges
    dev = rowptr.device
    n_rows = rowptr.shape[0] - 1
    ptr = rowptr.to(torch.int64)
    pieces = torch.clamp((torch.diff(ptr) + chunk - 1) // chunk, min=1)
    first = torch.cumsum(pieces, 0) - pieces      # each row's first item
    item_row = torch.repeat_interleave(torch.arange(n_rows, device=dev), pieces)
    num_items = item_row.shape[0]
    if num_items >= 2**31:
        raise ValueError(f"{num_items} work items: more than int32 indexing takes")
    piece = torch.arange(num_items, device=dev) - first[item_row]
    item_ptr = torch.empty(num_items + 1, dtype=torch.int32, device=dev)
    item_ptr[:-1] = (ptr[item_row] + piece * chunk).to(torch.int32)
    item_ptr[-1] = rowptr[-1]
    split = pieces > 1
    in_split = split[item_row]
    item_slot = torch.where(in_split, torch.cumsum(in_split, 0) - 1, -1)
    split_ptr = torch.zeros(int(split.sum().item()) + 1, dtype=torch.int32, device=dev)
    split_ptr[1:] = torch.cumsum(pieces[split], 0).to(torch.int32)
    return WorkList(item_ptr=item_ptr, item_row=item_row.to(torch.int32),
                    item_slot=item_slot.to(torch.int32),
                    split_row=torch.nonzero(split).flatten().to(torch.int32),
                    split_ptr=split_ptr, num_partials=int(split_ptr[-1].item()),
                    item_edges=geometry.edges, item_warps=geometry.warps)


def with_work(rows: EdgeRows, item_edges: int = CHUNK,
              item_warps: int = ITEM_WARPS) -> EdgeRows:
    """``rows`` with its work list (``work_list``'s geometry)."""
    return dataclasses.replace(rows, work=work_list(rows.rowptr, item_edges, item_warps))


def row_ids(rows: EdgeRows) -> torch.Tensor:
    """int64 write row of each grouped edge (the plain versions scatter by it)."""
    n_rows = rows.rowptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n_rows, device=rows.rowptr.device),
                                   torch.diff(rows.rowptr).to(torch.int64))
