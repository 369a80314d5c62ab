"""The numbers that decide ``correct``: a job's outputs against the plain
reference's, each number beside its limit.

* ``mismatches``: the exact outputs that differ, counted together (under
  the control the rebuild flags and sweep counts alone rarely differ):
  rounds whose seed differs (the seeds in the order chosen), rounds whose
  rebuild flag differs, and the absolute differences of the sweep counts
  the cell names (``build``, ``cascade``, ``rebuild``; the serial ring's build and
  rebuild sweeps are its own, since it runs comm-free sweeps between ring
  sweeps, which plain Alg. 4 has no counterpart of);
* ``score_gap``, ``gain_gap``: the largest relative gap of a round's score
  (VISITED registers over J) or estimated gain from the reference's.

A cell's file (``workloads/<cell>.json``) names the sweep counts it
compares (``sweeps``) and each number's limit (``limits``). A number that
is not a number (NaN) fails.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass
class Outputs:
    """One job's outputs, as the program returned them."""

    seeds: np.ndarray
    gains: np.ndarray
    scores: np.ndarray
    rebuilds: np.ndarray
    build_sweeps: int
    cascade_sweeps: int
    rebuild_sweeps: int


def _positions_differ(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int((a != b).sum())


def _gap(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return float("inf")
    if not a.size:
        return 0.0
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _mismatches(p, r, sweeps) -> int:
    return (_positions_differ(p.seeds, r.seeds) + _positions_differ(p.rebuilds, r.rebuilds)
            + sum(abs(getattr(p, f"{s}_sweeps") - getattr(r, f"{s}_sweeps")) for s in sweeps))


NUMBERS = {
    "mismatches": _mismatches,
    "score_gap": lambda p, r, sweeps: _gap(p.scores, r.scores),
    "gain_gap": lambda p, r, sweeps: _gap(p.gains, r.gains),
}
SWEEPS = ("build", "cascade", "rebuild")


def readings(program: Outputs, reference, spec: dict) -> Dict[str, float]:
    """Each number of a cell's check ``spec`` (``limits``, ``sweeps``) for
    one job."""
    sweeps = spec["sweeps"]
    if not set(sweeps) <= set(SWEEPS):
        raise ValueError(f"sweep counts are {SWEEPS}, not {sweeps}")
    return {name: NUMBERS[name](program, reference, sweeps) for name in spec["limits"]}


def worst(per_job) -> Dict[str, float]:
    """The worst reading of each number over the jobs checked (NaN wins)."""
    out: Dict[str, float] = {}
    for job in per_job:
        for name, value in job.items():
            old = out.get(name)
            if old is None or np.isnan(value) or (not np.isnan(old) and value > old):
                out[name] = value
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """``{name: {"value", "limit", "ok"}}``, in the limits' order."""
    return {name: {"value": values[name], "limit": limit,
                   "ok": bool(values[name] <= limit)}
            for name, limit in limits.items()}
