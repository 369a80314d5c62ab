"""``serial`` backend: the 2-D ring schedule run serially on one device
(``partition/serial.py``), over a ``(mu_v, mu_s)`` shard grid. It is the
backend that repairs individual plan shards of a store matrix
(``repair_plan_shards``), the hook behind ``service.delta``'s shard
repair; its ``fixpoint`` hook is that repair with every shard dirty.
``find_seeds`` and ``build_matrix`` apply the spec's tuning
(``apply_tuning``: the ring knobs ``local_sweeps``, ``pad_mode``,
``fuse_sweeps``, ``lane_fill``) before they run."""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.difuser import normalize_inputs
from repro_torch.core.sketch import VISITED
from repro_torch.device import resolve_device
from repro_torch.graphs.structs import Graph
from repro_torch.partition import serial as _serial
from repro_torch.partition.plan import plan_partition
from repro_torch.runtime.base import (Backend, BackendCapabilities, RunReport,
                                      apply_tuning, register_backend)
from repro_torch.runtime.spec import RunSpec


def _grid(spec: RunSpec) -> tuple:
    return max(spec.mu_v, 1), max(spec.mu_s, 1)


class SerialRingBackend(Backend):
    name = "serial"

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(name=self.name, distributed=True, shard_repair=True,
                                   description="serial-ring executor of the 2-D schedule")

    def supports(self, g, spec: RunSpec):
        _, mu_s = _grid(spec)
        if spec.num_registers % mu_s:
            return False, f"num_registers={spec.num_registers} not divisible by mu_s={mu_s}"
        return True, ""

    def find_seeds(self, g: Graph, k: int, spec: RunSpec, *,
                   x: Optional[np.ndarray] = None, mesh=None, plan=None,
                   device=None) -> RunReport:
        t0 = time.perf_counter()
        spec = apply_tuning(g, spec, self.name, device=device)
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
                     mesh=None, plan=None, device=None):
        # ``edges`` and ``mesh`` do not apply: the ring buckets its own
        # operands on one device
        spec = apply_tuning(g, spec, self.name, device=device)
        cfg = spec.difuser_config()
        if not normalized:
            g, x = normalize_inputs(g, cfg, x, device=resolve_device(device))
        mu_v, mu_s = _grid(spec)
        if np.asarray(x).shape[0] % mu_s:
            mu_s = 1   # a bank narrower than the sim grid stays whole
        m, iters, _ = _serial.build_matrix_ring_serial(
            g, cfg, x, mu_v=mu_v, mu_s=mu_s, strategy=spec.partition, plan=plan,
            pad_mode=spec.pad_mode, reg_offset=reg_offset,
            local_sweeps=spec.local_sweeps, fuse_sweeps=spec.fuse_sweeps,
            lane_fill=spec.lane_fill, device=device)
        return m, iters

    def fixpoint(self, m, g: Graph, spec: RunSpec, x: np.ndarray, *, edges=None,
                 device=None):
        """A canonical matrix to its fixpoint through a full ring repair (every
        shard starts dirty). ``g`` sorted by destination, ``x`` sorted; a
        tensor ``m`` stays on its device, a numpy one goes to ``device``.
        Returns ``(matrix, iters)``; ``m`` is not written."""
        if not isinstance(m, torch.Tensor):
            m = torch.from_numpy(np.require(m, np.int8, ["C", "W"])).to(
                resolve_device(device))
        mu_v, mu_s = _grid(spec)
        x = np.asarray(x, dtype=np.uint32)
        if x.shape[0] % mu_s:
            mu_s = 1
        cfg = spec.difuser_config()
        plan = plan_partition(g, mu_v, mu_s=mu_s, strategy=spec.partition, seed=cfg.seed,
                              model=cfg.model)
        extra = plan.n_pad - g.n_pad
        if extra > 0:
            m = torch.cat([m, torch.full((extra, m.shape[1]), VISITED, dtype=torch.int8,
                                         device=m.device)])
        inv = torch.from_numpy(plan.inv_perm.astype(np.int64)).to(m.device)
        planned, iters, _ = _serial.repair_plan_shards(
            g, cfg, x, m.index_select(0, inv), plan, range(mu_v), pad_mode=spec.pad_mode)
        perm = torch.from_numpy(plan.perm[:g.n_pad].astype(np.int64)).to(m.device)
        return planned.index_select(0, perm), iters

    def repair_plan_shards(self, g: Graph, spec: RunSpec, x: np.ndarray, planned_m, plan,
                           touched, *, mesh=None):
        """``partition.serial.repair_plan_shards``: ring sweeps restricted to
        the shards a delta dirtied and to those the repair spreads into, on
        the device of ``planned_m``."""
        return _serial.repair_plan_shards(g, spec.difuser_config(), x, planned_m, plan,
                                          touched, pad_mode=spec.pad_mode)


register_backend(SerialRingBackend())
