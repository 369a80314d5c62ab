"""Checks and launch plumbing shared by the kernel wrappers."""
from __future__ import annotations

import torch

from repro_torch.kernels.edges import EdgeOperands

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


def check_sweep(m: torch.Tensor, edges: EdgeOperands, x: torch.Tensor) -> None:
    """Operands of a propagate or cascade sweep."""
    check_matrix(m)
    if edges.n_pad != m.shape[0]:
        raise ValueError(f"edges are for {edges.n_pad} rows, m has {m.shape[0]}")
    if x.dtype != torch.int32 or tuple(x.shape) != (m.shape[1],) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous int32[{m.shape[1]}] tensor "
                         f"(uint32 bits), got {x.dtype} {tuple(x.shape)}")
    if edges.device != m.device or x.device != m.device:
        raise ValueError(f"m, x and edges must share a device: {m.device}, "
                         f"{x.device}, {edges.device}")


def stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer."""
    return torch.cuda.current_stream(device).cuda_stream
