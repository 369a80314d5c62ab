"""What one launch of each kernel costs: ``(integer operations, compulsory
bytes)`` from the launch's shapes, and the least time the card could take
for them.

One source for ``chip_smoke.py``'s bound column and for the dry run
(``launch.dryrun``, through ``kernels.ops``' ``meta`` branch). Bytes count
each input read once and each output written once; operations count the
integer work per element:

* the fill, per register: ``j * M2`` (one add from the word's base), xor,
  fmix32's 8, clz, byte pack (:data:`FILL_OPS`); the VISITED merge is per
  4-register word and not counted; a row-id operand adds one id a row;
* the cardinality, per register: compare, shift, 64-bit add, count
  (:data:`CARD_OPS`);
* a propagate merge or a sample, per (edge or slot, register): the predicate
  (xor, subtract, compare; the lt remix adds fmix32's 8) and the merge
  (:data:`SWEEP_OPS` by predicate variant);
* a cascade: one VISITED test per (edge or slot, 4-register word), the
  predicate only on the (edge, register) pairs whose read register is
  VISITED (``vis_pairs``). That count depends on the data: a caller without
  it (the dry run) passes none, and the figure is then a lower bound.

A bucket merge's bytes depend on the rows its slots write and read
(``write_rows``, ``read_rows``); without them (the dry run) each is taken
as ``min(slots, n_loc)``, the most the slots can touch.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.utils.roofline import HBM_BW, INT32_OPS

#: integer operations per (edge or slot, register), by predicate variant
SWEEP_OPS = {0: 4, 1: 12}
#: integer operations per register of the fill
FILL_OPS = 12
#: integer operations per register of the cardinality statistics
CARD_OPS = 5
#: the sweeps test VISITED on 4 registers at once
REGS_PER_WORD = 4

Cost = Tuple[int, int]


def sketch_fill(n: int, j: int, id_bytes: int = 0) -> Cost:
    """``id_bytes``: the bytes of a row id where the fill takes a row-id
    operand (4 or 8), else 0."""
    cells = n * j
    return FILL_OPS * cells, 2 * cells + id_bytes * n


def sketch_cardinality(n: int, j: int) -> Cost:
    cells = n * j
    return CARD_OPS * cells, cells + 8 * n


def _edge_bytes(n_pad: int, j: int, num_edges: int) -> int:
    """Each edge's read row, h, lo and thr, the row pointers and x."""
    return num_edges * 16 + (n_pad + 1) * 4 + j * 4


def sketch_propagate(n_pad: int, j: int, num_edges: int, variant: int) -> Cost:
    return (SWEEP_OPS[variant] * num_edges * j,
            2 * n_pad * j + _edge_bytes(n_pad, j, num_edges))


def cascade_step(n_pad: int, j: int, num_edges: int, variant: int,
                 vis_pairs: int = 0) -> Cost:
    """``vis_pairs``: (edge, register) pairs with a VISITED source (module
    doc); 0 gives the lower bound."""
    return (num_edges * j // REGS_PER_WORD + SWEEP_OPS[variant] * vis_pairs,
            2 * n_pad * j + _edge_bytes(n_pad, j, num_edges))


def _bucket_bytes(n_loc: int, j: int, slots: int, write_rows: Optional[int],
                  read_rows: Optional[int]) -> int:
    n_w = min(slots, n_loc) if write_rows is None else write_rows
    n_r = min(slots, n_loc) if read_rows is None else read_rows
    return 2 * n_w * j + n_r * j + 16 * slots + 4 * (n_loc + 1) + 4 * j


def bucket_propagate(n_loc: int, j: int, slots: int, variant: int, *,
                     write_rows: Optional[int] = None,
                     read_rows: Optional[int] = None) -> Cost:
    return (SWEEP_OPS[variant] * slots * j,
            _bucket_bytes(n_loc, j, slots, write_rows, read_rows))


def bucket_cascade(n_loc: int, j: int, slots: int, variant: int, *,
                   write_rows: Optional[int] = None, read_rows: Optional[int] = None,
                   vis_pairs: int = 0) -> Cost:
    """``vis_pairs`` as in ``cascade_step``; 0 gives the lower bound."""
    return (slots * j // REGS_PER_WORD + SWEEP_OPS[variant] * vis_pairs,
            _bucket_bytes(n_loc, j, slots, write_rows, read_rows))


def fused_sweep(n_loc: int, j: int, slots: int, variant: int, num_sweeps: int) -> Cost:
    return (num_sweeps * SWEEP_OPS[variant] * slots * j,
            2 * n_loc * j + 16 * slots + 4 * (n_loc + 1) + 4 * j)


def fused_sample(num_edges: int, num_samples: int, variant: int) -> Cost:
    return (SWEEP_OPS[variant] * num_edges * num_samples,
            num_edges * num_samples + 12 * num_edges + 4 * num_samples)


def bound_ms(cost: Cost) -> Tuple[float, str]:
    """``(ms, "bytes" or "operations")``: the larger of the bytes over the
    device memory rate and the operations over the INT32 rate, and which."""
    ops, nbytes = cost
    t_bytes, t_ops = nbytes / HBM_BW * 1e3, ops / INT32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
