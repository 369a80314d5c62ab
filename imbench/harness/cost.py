"""The least time Alg. 4's work needs on one H100, from the work's counts.

A frozen copy of the port's per-launch formulas
(``repro_torch.kernels.cost``) and roofs (``repro_torch.utils.roofline``):
each pass costs the larger of its compulsory bytes over the memory rate and
its integer operations over the INT32 rate. Bytes count each input read
once and each output written once, for the n real vertices and m real
edges. The cascade is counted at its lower bound: one VISITED test per
(edge, 4-register word), and no predicate, since how many pairs read a
VISITED register depends on the data.
"""
from __future__ import annotations

#: device memory, B/s (H100 SXM5 data sheet)
HBM_BW = 3.35e12
#: INT32 operations a second: 132 SMs x 64 lanes x 1.98 GHz
INT32_OPS = 132 * 64 * 1.98e9
#: integer operations per (edge, register) of a sweep, by predicate: the
#: interval test (xor, subtract, compare) and the merge; lt's remix adds
#: fmix32's 8
SWEEP_OPS = {"wc": 4, "lt": 12}
FILL_OPS = 12      # per register: j * M2, xor, fmix32's 8, clz, byte pack
CARD_OPS = 5       # per register: compare, shift, 64-bit add, count
REGS_PER_WORD = 4  # the cascade tests VISITED four registers at a time


def _seconds(ops: float, nbytes: float) -> float:
    return max(nbytes / HBM_BW, ops / INT32_OPS)


def _edge_bytes(n: int, j: int, m: int) -> int:
    return m * 16 + (n + 1) * 4 + j * 4


def fill_s(n: int, j: int) -> float:
    return _seconds(FILL_OPS * n * j, 2 * n * j)


def cardinality_s(n: int, j: int) -> float:
    return _seconds(CARD_OPS * n * j, n * j + 8 * n)


def propagate_s(n: int, j: int, m: int, model: str) -> float:
    return _seconds(SWEEP_OPS[model] * m * j, 2 * n * j + _edge_bytes(n, j, m))


def cascade_s(n: int, j: int, m: int) -> float:
    return _seconds(m * j // REGS_PER_WORD, 2 * n * j + _edge_bytes(n, j, m))


def job_bound_s(n: int, j: int, m: int, model: str, *, k: int, rebuilds: int,
                propagate_sweeps: int, cascade_sweeps: int) -> float:
    """One single-device job: 1 + rebuilds fills, its propagate and cascade
    sweeps, and K passes of the cardinality statistics."""
    return ((1 + rebuilds) * fill_s(n, j) + propagate_sweeps * propagate_s(n, j, m, model)
            + cascade_sweeps * cascade_s(n, j, m) + k * cardinality_s(n, j))
