"""RunSpec: what to run and how. Its sketch fields mirror
``core.difuser.DiFuserConfig``; the execution fields (``backend`` to
``item_warps``) choose and shape the backend, the serving fields (``slo`` to
``max_resident_mb``) configure the query engines, and ``tuning`` says where
the performance knobs come from (``repro_torch.tune``). None of them
changes a result (``residency`` included: it only says where the banks
live), and none enters ``DiFuserConfig``: the mesh backend reads
its share of them through ``distributed_config``. ``fasst`` is the one
exception there: on the mesh, as in the reference, ``fasst=False`` takes the
naive sample partition and returns x unsorted."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.difuser import DiFuserConfig
from repro_torch.diffusion.constants import DEFAULT_MODEL
from repro_torch.kernels.edges import CHUNK, ITEM_WARPS, ItemGeometry

_SKETCH_FIELDS = tuple(f.name for f in dataclasses.fields(DiFuserConfig))
#: the execution fields that ``DistributedConfig`` carries
_EXEC_FIELDS = ("vertex_axis", "sim_axes", "schedule", "fasst", "local_sweeps",
                "fuse_sweeps", "lane_fill", "partition", "pad_mode")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    # sketch and diffusion setting (DiFuserConfig)
    num_registers: int = 1024
    seed: int = 0
    estimator: str = "hll"
    rebuild_threshold: float = 0.01
    max_propagate_iters: int = 64
    max_cascade_iters: int = 64
    sort_x: bool = True
    model: str = DEFAULT_MODEL
    # execution strategy
    backend: str = "auto"        # "auto" | "single" | "serial" | "mesh"
    residency: str = "auto"      # "auto" | "host" | "device": where a store's
    #   banks live for serving; "device" places plan-order row blocks on the
    #   serving mesh (shard-local query reductions), "auto" follows the
    #   resolved backend (mesh -> device, else host; runtime.resolve_residency)
    mu_v: int = 1                # vertex shards of the 2-D grid
    mu_s: int = 1                # sample-space (sim) shards
    partition: str = "block"     # vertex-assignment strategy (partition.plan)
    pad_mode: str = "step"       # "step" | "global" bucket padding
    fasst: bool = True           # FASST sample partition (mesh: False = naive;
    #   the serial ring always sorts)
    schedule: str = "ring"       # "ring" | "allgather" (mesh backend)
    vertex_axis: str = "data"    # the mesh's axis names (launch.mesh)
    sim_axes: Tuple[str, ...] = ("model",)
    local_sweeps: int = 0        # comm-free sweeps before each ring sweep
    fuse_sweeps: bool = False    # run them as one fused_sweep call per shard
    lane_fill: int = 0           # the reference's register slab of the fused
    #   sweep; the port's fused_sweep takes and ignores it (the tuner's
    #   fused_sweep family still measures it)
    # the single path's work-item geometry (kernels.edges.ItemGeometry; 0 =
    # the default, CHUNK edges and ITEM_WARPS warps): edges an item of the
    # propagate and of the cascade sweep, and warps a block of both
    item_edges: int = 0
    cascade_item_edges: int = 0
    item_warps: int = 0
    # serving objectives: per-query-class p99 budgets, ((class, ms), ...),
    # read by the engines' SLO watchdog (empty: none)
    slo: Tuple[Tuple[str, float], ...] = ()
    # async serving (service.async_engine): serve_im --async routes through
    # it; deadline_ms is the end-to-end deadline of a query (0: the engine's
    # 50 ms); max_resident_mb caps the store's resident bytes and the
    # async engine's cross-entry stack (0: no cap)
    serve_async: bool = False
    deadline_ms: float = 0.0
    max_resident_mb: float = 0.0
    # measured kernel tuning (repro_torch.tune): "off" runs the fields above
    # as they are; "cached" overlays the tuning cache's winners (a miss keeps
    # them); "auto" measures a miss on the actual graph and persists it
    tuning: str = "off"

    @property
    def num_shards(self) -> int:
        """The shard grid's size (1 = unsharded)."""
        return max(self.mu_v, 1) * max(self.mu_s, 1)

    def difuser_config(self) -> DiFuserConfig:
        return DiFuserConfig(**{f: getattr(self, f) for f in _SKETCH_FIELDS})

    def distributed_config(self):
        """The ``core.distributed.DistributedConfig`` of the mesh backend:
        the sketch fields and the mesh's execution fields."""
        from repro_torch.core.distributed import DistributedConfig

        kw = {f: getattr(self, f) for f in _SKETCH_FIELDS + _EXEC_FIELDS}
        kw["sim_axes"] = tuple(self.sim_axes)
        return DistributedConfig(**kw)

    def item_geometry(self) -> dict:
        """The single path's ``propagate`` and ``cascade`` work-list geometry,
        as ``core.difuser``'s entry points take it."""
        warps = self.item_warps or ITEM_WARPS
        return dict(propagate=ItemGeometry(self.item_edges or CHUNK, warps),
                    cascade=ItemGeometry(self.cascade_item_edges or CHUNK, warps))

    @classmethod
    def from_config(cls, config: Optional[DiFuserConfig] = None,
                    base: Optional["RunSpec"] = None, **overrides) -> "RunSpec":
        """A RunSpec with ``config``'s sketch fields over ``base`` (or the
        defaults), then ``overrides``. ``config=None`` keeps ``base``'s
        sketch fields."""
        spec = base if base is not None else cls()
        kw = {f: getattr(config, f) for f in _SKETCH_FIELDS} if config is not None else {}
        kw.update(overrides)
        return dataclasses.replace(spec, **kw)

    def with_(self, **overrides) -> "RunSpec":
        """``dataclasses.replace`` as a method."""
        return dataclasses.replace(self, **overrides)
