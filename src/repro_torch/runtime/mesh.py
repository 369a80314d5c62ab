"""``mesh`` backend: the 2-D distributed runtime on a process mesh.

Counterpart of the reference's ``runtime/mesh.py``: wraps
``core/distributed.py``, one rank per ``(vertex, sim)`` shard
(``launch.mesh``). Every rank of the grid calls ``find_seeds`` or
``build_matrix`` with the same arguments and gets the same result. It needs
an initialized process group of at least ``mu_v * mu_s`` ranks; otherwise
``supports`` says no and ``auto`` takes the ``serial`` backend, which runs
the same ring schedule on one device (the same seeds by contract).

``repair_plan_shards`` is the shard-restricted repair of device-resident
banks (``core.distributed.repair_plan_shards_distributed``): a device
entry's placed matrix goes in and a new placement comes back, the blocks
staying on their ranks; a plain tensor is repaired SPMD, every rank of the
mesh calling with the same arguments and getting the whole matrix back.

Every call is SPMD. On the controller of a serving world
(``launch.mesh.serve_world``) the serving layer makes a cold call one
operation of the world (``service.world.backend_call``), so every rank
makes it; a placed matrix's repair runs through the placement's own
controller.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch.distributed as dist

from repro_torch.core.difuser import normalize_inputs
from repro_torch.device import resolve_device
from repro_torch.graphs.structs import Graph
from repro_torch.launch import mesh as launch_mesh
from repro_torch.runtime.base import (Backend, BackendCapabilities, BackendUnavailable,
                                      RunReport, apply_tuning, register_backend)
from repro_torch.runtime.spec import RunSpec


class MeshBackend(Backend):
    name = "mesh"

    def capabilities(self) -> BackendCapabilities:
        return BackendCapabilities(
            name=self.name, distributed=True, needs_mesh=True, shard_repair=True,
            description="2-D runtime on a process mesh (ring/allgather schedules; "
                        "shard-restricted repair of device-resident banks)")

    def available(self):
        if not dist.is_available():
            return False, "this torch build has no torch.distributed"
        return True, ""

    def supports(self, g, spec: RunSpec):
        ok, why = self.available()
        if not ok:
            return ok, why
        if not dist.is_initialized():
            return False, ("no process group is initialized (run under torchrun "
                           "--nproc-per-node N, or call launch.mesh.init_world)")
        world = dist.get_world_size()
        if world < spec.num_shards:
            return False, (f"spec asks for {spec.num_shards} shards but the process "
                           f"group has {world} rank(s)")
        if spec.num_registers % max(spec.mu_s, 1) != 0:
            return False, (f"num_registers={spec.num_registers} not divisible "
                           f"by mu_s={spec.mu_s}")
        return True, ""

    def _check(self, g, spec: RunSpec) -> None:
        ok, why = self.supports(g, spec)
        if not ok:
            raise BackendUnavailable(f"mesh backend: {why}")

    def _mesh_for(self, spec: RunSpec, mesh=None, device=None):
        """``mesh``, or the spec's ``(mu_v, mu_s)`` grid over the world; the
        mesh's device must be of the kind ``device`` asks for."""
        kind = resolve_device(device).type
        if mesh is None:
            from repro_torch.launch.mesh import make_mesh

            if len(spec.sim_axes) != 1:
                raise ValueError("pass an explicit mesh for multi-sim-axis specs")
            mesh = make_mesh((max(spec.mu_v, 1), max(spec.mu_s, 1)),
                             (spec.vertex_axis, spec.sim_axes[0]), device=device)
        if mesh.device.type != kind:
            raise ValueError(f"the mesh's rank runs on {mesh.device}, the call asks "
                             f"for {kind}")
        return mesh

    def _tuned(self, g, spec: RunSpec, mesh) -> RunSpec:
        """``apply_tuning`` on rank 0, its spec handed to every rank, so the
        ranks run one schedule."""
        if spec.tuning == "off":
            return spec
        box = [apply_tuning(g, spec, self.name, device=mesh.device)
               if mesh.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=mesh.grid_group)
        return box[0]

    def find_seeds(self, g: Graph, k: int, spec: RunSpec, *,
                   x: Optional[np.ndarray] = None, plan=None, device=None,
                   mesh=None) -> RunReport:
        self._check(g, spec)
        from repro_torch.core import distributed as _dist

        mesh = self._mesh_for(spec, mesh, device)
        t0 = time.perf_counter()
        spec = self._tuned(g, spec, mesh)
        res, part = _dist._find_seeds_distributed(g, k, mesh, spec.distributed_config(),
                                                  x, plan=plan)
        return RunReport(result=res, backend=self.name, spec=spec,
                         device=str(mesh.device), partition=part,
                         wall_s=time.perf_counter() - t0)

    def build_matrix(self, g: Graph, spec: RunSpec, x: np.ndarray, *,
                     reg_offset: int = 0, normalized: bool = False, edges=None,
                     plan=None, device=None, mesh=None):
        # ``edges`` does not apply: the ranks bucket their own operands
        self._check(g, spec)
        from repro_torch.core import distributed as _dist

        mesh = self._mesh_for(spec, mesh, device)
        spec = self._tuned(g, spec, mesh)
        cfg = spec.distributed_config()
        if not normalized:
            g, x = normalize_inputs(g, cfg, x)
        if x is not None and np.asarray(x).shape[0] % mesh.mu_s != 0:
            raise ValueError(f"bank of {np.asarray(x).shape[0]} registers not divisible "
                             f"by the mesh's {mesh.mu_s} sim shard(s)")
        m, iters, _ = _dist.build_matrix_distributed(g, mesh, cfg, x,
                                                     reg_offset=reg_offset, plan=plan)
        return m, iters

    def repair_plan_shards(self, g: Graph, spec: RunSpec, x: np.ndarray, planned_m, plan,
                           touched, *, mesh=None):
        """The frontier-restricted re-propagation of the touched plan shards
        (``core.distributed.repair_plan_shards_distributed``), byte-equal to
        the serial repair and to a full rebuild. ``planned_m``: a device
        entry's ``Placement`` (its mesh is the repair's; the result is a new
        placement on it) or a plan-order tensor (every rank of ``mesh`` calls
        with the same one, SPMD, and gets the repaired matrix). Without a
        mesh a ``(plan.mu_v, 1)`` serving mesh is made. Returns
        ``(planned_matrix, sweeps, shards_swept)``."""
        ok, why = self.available()
        if not ok:
            raise BackendUnavailable(f"mesh backend: {why}")
        if isinstance(planned_m, launch_mesh.Placement):
            if mesh is not None and mesh is not planned_m.mesh:
                raise ValueError("a placed matrix is repaired on the mesh it lives on")
            mesh = planned_m.mesh
        elif mesh is None:
            mesh = launch_mesh.make_serving_mesh(plan.mu_v, vertex_axis=spec.vertex_axis,
                                                 device=planned_m.device.type)
        sim_axes = tuple(ax for ax in mesh.axis_names if ax != spec.vertex_axis)
        cfg = spec.with_(vertex_axis=mesh.axis_names[0],
                         sim_axes=sim_axes).distributed_config()
        x = np.asarray(x, dtype=np.uint32)
        from repro_torch.core import distributed as _dist

        if isinstance(planned_m, launch_mesh.Placement):
            ctl = planned_m.ctl
            out = ctl.new_id()
            sweeps, swept = ctl.call(_dist._op_repair, dict(
                mesh=mesh.key, hid=planned_m.hid, out=out, graph=ctl.share_graph(g),
                plan=ctl.share_plan(plan), x=x, cfg=cfg, touched=tuple(touched)))
            return launch_mesh.adopt_block(mesh, out, plan.n_loc), sweeps, swept
        v = mesh.coord[0]
        n_loc = plan.n_loc
        block, sweeps, swept = _dist.repair_plan_shards_distributed(
            g, mesh, cfg, x, planned_m[v * n_loc:(v + 1) * n_loc], plan, touched)
        blocks = mesh.exchange.all_gather(block, mesh.vertex_group, mesh.mu_v)
        return blocks.reshape(-1, block.shape[1]), sweeps, swept


register_backend(MeshBackend())
