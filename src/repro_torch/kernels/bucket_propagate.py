"""Ring-step bucket merges of the serial-ring backend, in place on ``acc``.

* propagate: where the predicate fires on slot (w, r) for register j,
  ``acc[w, j] = max(acc[w, j], block[r, j])``; VISITED entries of ``acc``
  stay VISITED, the contract of the Pallas kernel
  ``src/repro/kernels/bucket_propagate.py`` (``bucket_propagate_pallas``),
  which ``csrc/bucket_propagate.cu`` replaces;
* cascade: where the predicate fires and ``block[r, j]`` is VISITED,
  ``acc[w, j] = VISITED``, the reference's jnp ``_bucket_sweep_cascade``
  (``core/distributed.py``), in the same source as a second entry point.

A bucket's slots come as ``kernels.edges.EdgeRows`` grouped by write row
(``nbr`` is the read row r), made once per partition with their work list
(``edges.with_work``). ``acc`` and ``block`` are ``int8[n_loc, j_loc]`` and
must not share memory: the merge reads ``block`` while it writes ``acc``.
Each function updates ``acc`` in place (the reference returns a new array;
in place saves one block per merge) and returns an ``int32[1]`` flag on the
device, nonzero when ``acc`` changed. ``*_cuda`` launch the kernels,
``*_plain`` are their plain PyTorch versions.

Both kernels walk the bucket's work list (one warp an item of at most
``edges.CHUNK`` slots, an item without slots returning at once) and keep
the split rows' partials in ``partial``, a scratch of at least
``num_partials x j_loc`` bytes that the caller may pass in to reuse across
launches (the serial ring allocates one for all its buckets); without it
the wrapper allocates one. The plain versions ignore it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.sampling import PREDICATES, as_u32
from repro_torch.core.sketch import VISITED
from repro_torch.kernels import build, counters
from repro_torch.kernels.common import (PLAIN_STEP, check_cuda, check_partial, check_rows,
                                        item_operands, partial_scratch, stream, work_of)
from repro_torch.kernels.edges import EdgeRows, row_ids

NAME = "bucket_propagate"
NAME_CASCADE = "bucket_cascade"


def _check(acc: torch.Tensor, block: torch.Tensor, rows: EdgeRows, x: torch.Tensor):
    check_rows(acc, rows, x)
    if block.dtype != acc.dtype or block.shape != acc.shape or not block.is_contiguous():
        raise ValueError(f"block must be a contiguous int8{tuple(acc.shape)} tensor, "
                         f"got {block.dtype} {tuple(block.shape)}")
    if block.device != acc.device:
        raise ValueError(f"acc and block must share a device: {acc.device}, {block.device}")
    # meta tensors (the dry run) have no memory to share
    if acc.device.type != "meta" and (acc.untyped_storage().data_ptr()
                                      == block.untyped_storage().data_ptr()):
        raise ValueError("acc and block must not share memory (the merge reads block "
                         "while it writes acc)")


def _launch_merge(name: str, acc, block, rows: EdgeRows, x, variant: int,
                  partial: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the in-place item merge ``name`` over ``rows``' work list."""
    _check(acc, block, rows, x)
    dev = check_cuda(acc)
    check_cuda(block)
    work = work_of(rows)
    if partial is None:
        partial = partial_scratch(work, acc.shape[1], dev)
    else:
        check_partial(partial, work, acc, block)
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = build.load(name, work.item_warps)
    build.check(name, fn(acc.data_ptr(), block.data_ptr(), partial.data_ptr(),
                         *item_operands(rows, x), work.num_items, work.num_split,
                         acc.shape[1], int(variant), changed.data_ptr(), stream(dev)))
    counters.launched(name)
    return changed


def bucket_propagate_cuda(acc, block, rows: EdgeRows, x, *, variant: int,
                          partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _launch_merge(NAME, acc, block, rows, x, variant, partial)


def bucket_cascade_cuda(acc, block, rows: EdgeRows, x, *, variant: int,
                        partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _launch_merge(NAME_CASCADE, acc, block, rows, x, variant, partial)


def _slot_chunks(rows: EdgeRows, x, variant: int, num_regs: int):
    """(write rows, read rows, live mask) per chunk of slots."""
    pred = PREDICATES[int(variant)]
    xs = as_u32(x)[None, :]
    w_all = row_ids(rows)
    step = max(1, PLAIN_STEP // max(num_regs, 1))
    for e0 in range(0, rows.nbr.shape[0], step):
        sl = slice(e0, e0 + step)
        live = pred(as_u32(rows.h[sl])[:, None], as_u32(rows.lo[sl])[:, None],
                    as_u32(rows.thr[sl])[:, None], xs)
        yield w_all[sl], rows.nbr[sl].to(torch.int64), live


def merge_propagate_plain(acc, block, rows: EdgeRows, x, variant: int) -> torch.Tensor:
    """The propagate merge without the checks and counters (shared with
    ``fused_sweep``'s plain version)."""
    new = acc.to(torch.int32)
    for w, r, live in _slot_chunks(rows, x, variant, acc.shape[1]):
        contrib = torch.where(live, block[r].to(torch.int32), VISITED)
        new.scatter_reduce_(0, w[:, None].expand_as(contrib), contrib, "amax")
    new = torch.where(acc == VISITED, acc, new.to(torch.int8))
    changed = (new != acc).any().reshape(1).to(torch.int32)
    acc.copy_(new)
    return changed


def bucket_propagate_plain(acc, block, rows: EdgeRows, x, *, variant: int,
                           partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check(acc, block, rows, x)
    counters.plain_called(NAME)
    return merge_propagate_plain(acc, block, rows, x, variant)


def bucket_cascade_plain(acc, block, rows: EdgeRows, x, *, variant: int,
                         partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    _check(acc, block, rows, x)
    counters.plain_called(NAME_CASCADE)
    vis = (acc == VISITED).to(torch.int32)
    block_vis = block == VISITED
    for w, r, live in _slot_chunks(rows, x, variant, acc.shape[1]):
        newly = (live & block_vis[r]).to(torch.int32)
        vis.scatter_reduce_(0, w[:, None].expand_as(newly), newly, "amax")
    new = torch.where(vis > 0, torch.full_like(acc, VISITED), acc)
    changed = (new != acc).any().reshape(1).to(torch.int32)
    acc.copy_(new)
    return changed
