"""``serial`` backend: the 2-D ring schedule run serially on one device
(``partition/serial.py``), over a ``(mu_v, mu_s)`` shard grid."""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core.difuser import normalize_inputs
from repro_torch.device import resolve_device
from repro_torch.graphs.structs import Graph
from repro_torch.partition import serial as _serial
from repro_torch.runtime.base import (Backend, BackendCapabilities, RunReport,
                                      register_backend)
from repro_torch.runtime.spec import RunSpec


def _grid(spec: RunSpec) -> tuple:
    return max(spec.mu_v, 1), max(spec.mu_s, 1)


class SerialRingBackend(Backend):
    name = "serial"

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(name=self.name, distributed=True,
                                   description="serial-ring executor of the 2-D schedule")

    def supports(self, g, spec: RunSpec):
        _, mu_s = _grid(spec)
        if spec.num_registers % mu_s:
            return False, f"num_registers={spec.num_registers} not divisible by mu_s={mu_s}"
        return True, ""

    def find_seeds(self, g: Graph, k: int, spec: RunSpec, *,
                   x: Optional[np.ndarray] = None, plan=None, device=None) -> RunReport:
        t0 = time.perf_counter()
        mu_v, mu_s = _grid(spec)
        res, part = _serial.find_seeds_ring_serial(
            g, k, spec.difuser_config(), mu_v=mu_v, mu_s=mu_s, strategy=spec.partition,
            plan=plan, x=x, pad_mode=spec.pad_mode, local_sweeps=spec.local_sweeps,
            fuse_sweeps=spec.fuse_sweeps, lane_fill=spec.lane_fill, device=device)
        return RunReport(result=res, backend=self.name, spec=spec,
                         device=str(resolve_device(device)), partition=part,
                         wall_s=time.perf_counter() - t0)

    def build_matrix(self, g: Graph, spec: RunSpec, x: np.ndarray, *,
                     reg_offset: int = 0, normalized: bool = False, edges=None,
                     plan=None, device=None):
        # ``edges`` does not apply: the ring buckets its own operands
        cfg = spec.difuser_config()
        if not normalized:
            g, x = normalize_inputs(g, cfg, x)
        mu_v, mu_s = _grid(spec)
        if np.asarray(x).shape[0] % mu_s:
            mu_s = 1   # a bank narrower than the sim grid stays whole
        m, iters, _ = _serial.build_matrix_ring_serial(
            g, cfg, x, mu_v=mu_v, mu_s=mu_s, strategy=spec.partition, plan=plan,
            pad_mode=spec.pad_mode, reg_offset=reg_offset,
            local_sweeps=spec.local_sweeps, fuse_sweeps=spec.fuse_sweeps,
            lane_fill=spec.lane_fill, device=device)
        return m, iters


register_backend(SerialRingBackend())
