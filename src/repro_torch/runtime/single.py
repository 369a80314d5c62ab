"""``single`` backend: the single-device Alg. 4 driver of core/difuser.py."""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core import difuser as _difuser
from repro_torch.device import resolve_device
from repro_torch.graphs.structs import Graph
from repro_torch.runtime.base import (Backend, BackendCapabilities, RunReport,
                                      register_backend)
from repro_torch.runtime.spec import RunSpec


class SingleDeviceBackend(Backend):
    name = "single"

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(name=self.name, distributed=False,
                                   description="single-device Alg. 4")

    def find_seeds(self, g: Graph, k: int, spec: RunSpec, *,
                   x: Optional[np.ndarray] = None, plan=None, device=None) -> RunReport:
        t0 = time.perf_counter()
        res = _difuser.find_seeds(g, k, spec.difuser_config(), x, device=device)
        return RunReport(result=res, backend=self.name, spec=spec,
                         device=str(resolve_device(device)),
                         wall_s=time.perf_counter() - t0)

    def build_matrix(self, g: Graph, spec: RunSpec, x: np.ndarray, *,
                     reg_offset: int = 0, normalized: bool = False, edges=None,
                     plan=None, device=None):
        m, iters, _ = _difuser.build_sketch_matrix(
            g, spec.difuser_config(), x, reg_offset=reg_offset, normalized=normalized,
            edges=edges, device=device)
        return m, iters


register_backend(SingleDeviceBackend())
