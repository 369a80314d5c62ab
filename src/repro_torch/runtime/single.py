"""``single`` backend: the single-device Alg. 4 driver of core/difuser.py,
and its two inner hooks (``fixpoint``, ``cascade``) over the port's edge
operands. Each entry applies the spec's tuning (``apply_tuning``) and lowers
the edges at the tuned spec's work-list geometry (``RunSpec.item_geometry``)."""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import difuser as _difuser
from repro_torch.core.cascade import cascade_from_seed
from repro_torch.core.simulate import propagate_to_fixpoint
from repro_torch.core.sketch import real_columns
from repro_torch.device import resolve_device
from repro_torch.diffusion import resolve as resolve_model
from repro_torch.graphs.structs import Graph
from repro_torch.runtime.base import (Backend, BackendCapabilities, RunReport,
                                      apply_tuning, register_backend)
from repro_torch.runtime.spec import RunSpec


class SingleDeviceBackend(Backend):
    name = "single"

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(name=self.name, distributed=False,
                                   description="single-device Alg. 4")

    def find_seeds(self, g: Graph, k: int, spec: RunSpec, *,
                   x: Optional[np.ndarray] = None, mesh=None, plan=None,
                   device=None) -> RunReport:
        t0 = time.perf_counter()
        spec = apply_tuning(g, spec, self.name, device=device)
        res = _difuser.find_seeds(g, k, spec.difuser_config(), x, device=device,
                                  **spec.item_geometry())
        return RunReport(result=res, backend=self.name, spec=spec,
                         device=str(resolve_device(device)),
                         wall_s=time.perf_counter() - t0)

    def build_matrix(self, g: Graph, spec: RunSpec, x: np.ndarray, *,
                     reg_offset: int = 0, normalized: bool = False, edges=None,
                     mesh=None, plan=None, device=None):
        spec = apply_tuning(g, spec, self.name, device=device)
        m, iters, _ = _difuser.build_sketch_matrix(
            g, spec.difuser_config(), x, reg_offset=reg_offset, normalized=normalized,
            edges=edges, device=device, **spec.item_geometry())
        return m, iters

    @staticmethod
    def _operands(m, g: Graph, spec: RunSpec, x: np.ndarray, edges, device):
        """(padded matrix, edges, x, variant, config) on the matrix's device
        (a numpy ``m`` goes to ``device``)."""
        dev = m.device if isinstance(m, torch.Tensor) else resolve_device(device)
        spec = apply_tuning(g, spec, SingleDeviceBackend.name, device=dev)
        cfg = spec.difuser_config()
        if edges is None:
            edges = _difuser.edge_operands(g, cfg, dev, **spec.item_geometry())
        x = np.asarray(x, dtype=np.uint32)
        return (_difuser._as_matrix(m, x.shape[0], dev), edges, _difuser.x_tensor(x, dev),
                resolve_model(cfg.model).variant, cfg)

    def fixpoint(self, m, g: Graph, spec: RunSpec, x: np.ndarray, *, edges=None,
                 device=None):
        """Propagate sweeps from ``m`` (canonical layout; ``g`` sorted by
        destination, ``x`` sorted) to the fixpoint. Returns ``(matrix,
        iters)``; ``m`` is not written."""
        m_p, edges, x_t, variant, cfg = self._operands(m, g, spec, x, edges, device)
        out, iters = propagate_to_fixpoint(m_p, edges, x_t, variant=variant,
                                           max_iters=cfg.max_propagate_iters)
        return real_columns(out, len(x)), iters

    def cascade(self, m, seed_vertex: int, g: Graph, spec: RunSpec, x: np.ndarray, *,
                edges=None, device=None):
        """Commit ``seed_vertex`` in ``m`` and spread its cascade to the
        fixpoint. Returns ``(matrix, iters)``; ``m`` is not written."""
        m_p, edges, x_t, variant, cfg = self._operands(m, g, spec, x, edges, device)
        out, iters = cascade_from_seed(m_p, int(seed_vertex), edges, x_t, variant=variant,
                                       max_iters=cfg.max_cascade_iters)
        return real_columns(out, len(x)), iters


register_backend(SingleDeviceBackend())
