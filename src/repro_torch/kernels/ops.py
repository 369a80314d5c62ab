"""Device dispatch over the kernels and their plain versions.

A tensor on the CPU takes the plain PyTorch version. A CUDA tensor launches
the CUDA kernel, which raises when its library cannot be built or loaded;
nothing falls back. The launch and call counters (``kernels.counters``) show
which of the two ran.

A ``meta`` tensor (only the dry run, ``launch.dryrun``, makes them) takes the
kernel's shape function: the plain version's checks, then ``meta`` outputs
of the plain version's shapes and dtypes. It computes nothing; it counts a
dry launch with its cost from ``kernels.cost``. Any other device raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cost, counters
from repro_torch.kernels import fused_sample as _sample
from repro_torch.kernels import fused_sweep as _fused
from repro_torch.kernels.bucket_propagate import _check as _check_merge
from repro_torch.kernels.bucket_propagate import (bucket_cascade_cuda,
                                                  bucket_cascade_plain,
                                                  bucket_propagate_cuda,
                                                  bucket_propagate_plain)
from repro_torch.kernels.cascade_step import cascade_sweep_cuda, cascade_sweep_plain
from repro_torch.kernels.common import check_matrix, check_rows, check_sweep, work_of
from repro_torch.kernels.edges import EdgeOperands, EdgeRows
from repro_torch.kernels.fused_sample import fused_sample_cuda, fused_sample_plain
from repro_torch.kernels.fused_sweep import fused_sweep_cuda, fused_sweep_plain
from repro_torch.kernels.sketch_cardinality import (cardinality_stats_cuda,
                                                    cardinality_stats_plain)
from repro_torch.kernels.sketch_fill import check_ids, sketch_fill_cuda, sketch_fill_plain
from repro_torch.kernels.sketch_propagate import (propagate_sweep_cuda,
                                                  propagate_sweep_plain)


def _pick(t: torch.Tensor, cuda, plain, meta):
    kind = t.device.type
    if kind == "cuda":
        return cuda
    if kind == "cpu":
        return plain
    if kind == "meta":
        return meta
    raise ValueError(f"unsupported device {t.device}: use cuda or cpu")


# -- the shape functions of the meta branch ----------------------------------------

def _dry(name: str, launch_cost, out):
    counters.dry_launched(name, launch_cost)
    return out


def _flag(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(1, dtype=torch.int32, device=t.device)


def _fill_meta(m, *, ids=None, reg_offset=0, seed=0):
    check_matrix(m)
    check_ids(ids, m)
    id_bytes = 0 if ids is None else ids.element_size()
    return _dry("sketch_fill", cost.sketch_fill(*m.shape, id_bytes=id_bytes),
                torch.empty_like(m))


def _cardinality_meta(m):
    check_matrix(m)
    return _dry("sketch_cardinality", cost.sketch_cardinality(*m.shape),
                torch.empty((2, m.shape[0]), dtype=torch.float32, device=m.device))


def _propagate_meta(m, edges, x, *, variant):
    check_sweep(m, edges, x)
    return _dry("sketch_propagate", cost.sketch_propagate(*m.shape, edges.num_edges, variant),
                (torch.empty_like(m), _flag(m)))


def _cascade_meta(m, edges, x, *, variant):
    check_sweep(m, edges, x)
    return _dry("cascade_step", cost.cascade_step(*m.shape, edges.num_edges, variant),
                (torch.empty_like(m), _flag(m)))


def _sample_meta(h, lo, thr, x, *, variant):
    _sample._check(h, lo, thr, x)
    return _dry("fused_sample", cost.fused_sample(h.shape[0], x.shape[0], variant),
                torch.empty((h.shape[0], x.shape[0]), dtype=torch.uint8, device=h.device))


def _fused_sweep_meta(m, rows, x, *, variant, num_sweeps=1, lane_fill=0):
    check_rows(m, rows, x)
    _fused._check_counts(num_sweeps, lane_fill)
    work_of(rows)
    return _dry("fused_sweep", cost.fused_sweep(*m.shape, rows.nbr.shape[0], variant,
                                                int(num_sweeps)), torch.empty_like(m))


def _merge_meta(name: str, merge_cost):
    def meta(acc, block, rows, x, *, variant, partial=None):
        _check_merge(acc, block, rows, x)
        work_of(rows)
        return _dry(name, merge_cost(*acc.shape, rows.nbr.shape[0], variant), _flag(acc))
    return meta


_bucket_propagate_meta = _merge_meta("bucket_propagate", cost.bucket_propagate)
_bucket_cascade_meta = _merge_meta("bucket_cascade", cost.bucket_cascade)


# -- the dispatch ---------------------------------------------------------------------

def sketch_fill(m: torch.Tensor, *, ids: Optional[torch.Tensor] = None,
                reg_offset: int = 0, seed: int = 0) -> torch.Tensor:
    """The fill of ``m``'s rows; row r is vertex ``ids[r]`` where ``ids`` is
    given, else vertex r."""
    fn = _pick(m, sketch_fill_cuda, sketch_fill_plain, _fill_meta)
    return fn(m, ids=ids, reg_offset=reg_offset, seed=seed)


def cardinality_stats(m: torch.Tensor) -> torch.Tensor:
    return _pick(m, cardinality_stats_cuda, cardinality_stats_plain, _cardinality_meta)(m)


def propagate_sweep(m: torch.Tensor, edges: EdgeOperands, x: torch.Tensor, *,
                    variant: int):
    fn = _pick(m, propagate_sweep_cuda, propagate_sweep_plain, _propagate_meta)
    return fn(m, edges, x, variant=variant)


def cascade_sweep(m: torch.Tensor, edges: EdgeOperands, x: torch.Tensor, *,
                  variant: int):
    fn = _pick(m, cascade_sweep_cuda, cascade_sweep_plain, _cascade_meta)
    return fn(m, edges, x, variant=variant)


def fused_sample(h: torch.Tensor, lo: torch.Tensor, thr: torch.Tensor, x: torch.Tensor, *,
                 variant: int) -> torch.Tensor:
    fn = _pick(h, fused_sample_cuda, fused_sample_plain, _sample_meta)
    return fn(h, lo, thr, x, variant=variant)


def fused_sweep(m: torch.Tensor, rows: EdgeRows, x: torch.Tensor, *, variant: int,
                num_sweeps: int = 1, lane_fill: int = 0) -> torch.Tensor:
    fn = _pick(m, fused_sweep_cuda, fused_sweep_plain, _fused_sweep_meta)
    return fn(m, rows, x, variant=variant, num_sweeps=num_sweeps, lane_fill=lane_fill)


def bucket_propagate(acc: torch.Tensor, block: torch.Tensor, rows: EdgeRows,
                     x: torch.Tensor, *, variant: int,
                     partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    fn = _pick(acc, bucket_propagate_cuda, bucket_propagate_plain, _bucket_propagate_meta)
    return fn(acc, block, rows, x, variant=variant, partial=partial)


def bucket_cascade(acc: torch.Tensor, block: torch.Tensor, rows: EdgeRows,
                   x: torch.Tensor, *, variant: int,
                   partial: Optional[torch.Tensor] = None) -> torch.Tensor:
    fn = _pick(acc, bucket_cascade_cuda, bucket_cascade_plain, _bucket_cascade_meta)
    return fn(acc, block, rows, x, variant=variant, partial=partial)
