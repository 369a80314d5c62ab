"""The state carried between the reference package and the port.

A register matrix built by the reference (``int8[n_pad, J]``), its ``x``
(``uint32[J]``) and its edge operands ``(src, dst, h, lo, thr)`` as numpy
arrays become the port's tensors on a device, ready for
``core.difuser.find_seeds_warm``; ``to_numpy`` goes the other way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.edges import EdgeOperands


@dataclasses.dataclass(frozen=True)
class WarmState:
    matrix: torch.Tensor   # int8[n_pad, J]
    x: np.ndarray          # uint32[J]
    edges: EdgeOperands


def from_reference(matrix, x, edges, *, device=None) -> WarmState:
    """Numpy (matrix, x, (src, dst, h, lo, thr)) to the port's tensors."""
    dev = resolve_device(device)
    matrix = np.require(matrix, np.int8, ["C", "W"])
    src, dst, h, lo, thr = (np.asarray(a) for a in edges)
    ops = EdgeOperands.from_numpy(src, dst, h, lo, thr, matrix.shape[0], dev)
    return WarmState(matrix=torch.from_numpy(matrix).to(dev),
                     x=np.asarray(x, dtype=np.uint32), edges=ops)


def to_numpy(state: WarmState):
    """The port's state as numpy: (matrix, x, (src, dst, h, lo, thr)), with
    h, lo and thr as uint32."""
    e = state.edges

    def u32(t):
        return t.cpu().numpy().view(np.uint32)

    return (state.matrix.cpu().numpy(), state.x,
            (e.src.cpu().numpy(), e.dst.cpu().numpy(), u32(e.h), u32(e.lo), u32(e.thr)))
