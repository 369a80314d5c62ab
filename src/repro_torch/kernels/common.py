"""Checks and launch plumbing shared by the kernel wrappers."""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.edges import EdgeOperands, EdgeRows, WorkList

#: elements of (edge, register) or (row, register) work per step of a plain
#: version; bounds its int64 temporaries to a few hundred MiB
PLAIN_STEP = 1 << 23


def check_matrix(m: torch.Tensor, what: str = "m") -> None:
    if not isinstance(m, torch.Tensor) or m.dtype != torch.int8 or m.dim() != 2:
        raise TypeError(f"{what} must be an int8[n, J] tensor, got "
                        f"{getattr(m, 'dtype', type(m))} {tuple(getattr(m, 'shape', ()))}")
    if not m.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if m.shape[0] >= 2**31 or m.shape[1] >= 2**31:
        raise ValueError(f"{what} is too large for int32 indexing: {tuple(m.shape)}")


def check_cuda(m: torch.Tensor) -> torch.device:
    """The layout the CUDA kernels take: rows of whole 32-bit words (the
    register count a multiple of 4) from a 4-byte aligned base."""
    if m.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {m.device}")
    if m.shape[1] % 4 or m.data_ptr() % 4:
        raise ValueError(f"the CUDA kernels take a register count that is a multiple "
                         f"of 4 and a 4-byte aligned matrix, got J={m.shape[1]}")
    return m.device


def check_x(x: torch.Tensor, num_regs: int) -> None:
    if x.dtype != torch.int32 or tuple(x.shape) != (num_regs,) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous int32[{num_regs}] tensor "
                         f"(uint32 bits), got {x.dtype} {tuple(x.shape)}")


def check_sweep(m: torch.Tensor, edges: EdgeOperands, x: torch.Tensor) -> None:
    """Operands of a propagate or cascade sweep."""
    check_matrix(m)
    if edges.n_pad != m.shape[0]:
        raise ValueError(f"edges are for {edges.n_pad} rows, m has {m.shape[0]}")
    check_x(x, m.shape[1])
    if edges.device != m.device or x.device != m.device:
        raise ValueError(f"m, x and edges must share a device: {m.device}, "
                         f"{x.device}, {edges.device}")


def check_rows(m: torch.Tensor, rows: EdgeRows, x: torch.Tensor) -> None:
    """Operands of a sweep over grouped rows (``kernels.edges.group_rows``)
    whose write rows and read rows both index ``m``'s rows."""
    check_matrix(m)
    check_x(x, m.shape[1])
    if tuple(rows.rowptr.shape) != (m.shape[0] + 1,):
        raise ValueError(f"rows are for {rows.rowptr.shape[0] - 1} rows, m has {m.shape[0]}")
    tensors = (rows.rowptr, rows.nbr, rows.h, rows.lo, rows.thr)
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in tensors):
        raise ValueError("row operands must be contiguous int32 tensors")
    if any(t.device != m.device for t in (x, *tensors)):
        raise ValueError(f"m, x and rows must share a device, m is on {m.device}")


def work_of(rows: EdgeRows) -> WorkList:
    """``rows``' work list, which the work-item kernels take."""
    if rows.work is None:
        raise ValueError("the work-item kernels take rows with a work list (edges.with_work)")
    if rows.work.item_ptr.device != rows.rowptr.device:
        raise ValueError(f"the work list is on {rows.work.item_ptr.device}, the rows on "
                         f"{rows.rowptr.device}")
    return rows.work


def partial_scratch(work: WorkList, num_regs: int, device) -> torch.Tensor:
    """The split rows' partial rows of one work-item sweep: ``num_partials x
    num_regs`` bytes."""
    return torch.empty((work.num_partials, num_regs), dtype=torch.int8, device=device)


def check_partial(partial: torch.Tensor, work: WorkList, m: torch.Tensor, *others) -> None:
    """A partial scratch passed in: int8, contiguous, ``num_regs`` wide, at
    least ``num_partials`` rows, on ``m``'s device and sharing memory with
    none of ``m`` and ``others``."""
    if (partial.dtype != torch.int8 or partial.dim() != 2 or not partial.is_contiguous()
            or partial.shape[1] != m.shape[1] or partial.shape[0] < work.num_partials):
        raise ValueError(f"partial must be a contiguous int8[>= {work.num_partials}, "
                         f"{m.shape[1]}] tensor, got {partial.dtype} {tuple(partial.shape)}")
    if partial.device != m.device:
        raise ValueError(f"partial is on {partial.device}, the matrix on {m.device}")
    ptr = partial.untyped_storage().data_ptr()
    if partial.numel() and any(ptr == t.untyped_storage().data_ptr() for t in (m, *others)):
        raise ValueError("partial must not share memory with the matrices")


def item_operands(rows: EdgeRows, x: torch.Tensor) -> tuple:
    """Pointers of a work-item kernel's list and edge operands: the work
    list (5), ``nbr``, ``h``, ``lo``, ``thr`` and ``x``."""
    work = work_of(rows)
    return tuple(t.data_ptr() for t in (
        work.item_ptr, work.item_row, work.item_slot, work.split_row, work.split_ptr,
        rows.nbr, rows.h, rows.lo, rows.thr, x))


def launch_item_sweep(name: str, m: torch.Tensor, rows: EdgeRows, x: torch.Tensor,
                      variant: int):
    """Launch the work-item sweep kernel ``name`` (``sketch_propagate`` or
    ``cascade_step``) over ``rows`` and their work list, from the library
    built at the list's block shape (``work.item_warps``). Returns ``(out,
    changed)``; the split rows' partials live in a scratch of
    ``num_partials x J`` bytes for the length of the call."""
    dev = check_cuda(m)
    work = work_of(rows)
    fn = build.load(name, work.item_warps)
    out = torch.empty_like(m)
    partial = partial_scratch(work, m.shape[1], dev)
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    build.check(name, fn(m.data_ptr(), out.data_ptr(), partial.data_ptr(),
                         *item_operands(rows, x), work.num_items, work.num_split,
                         m.shape[1], int(variant), changed.data_ptr(), stream(dev)))
    return out, changed


def stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer."""
    return torch.cuda.current_stream(device).cuda_stream
