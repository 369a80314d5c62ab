"""RunSpec: what to run and how. Its sketch fields mirror
``core.difuser.DiFuserConfig``; the execution fields (``backend`` to
``lane_fill``) choose and shape the backend, and the serving fields
(``slo`` to ``max_resident_mb``) configure the query engines. Neither
changes a result."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.difuser import DiFuserConfig
from repro_torch.diffusion.constants import DEFAULT_MODEL

_SKETCH_FIELDS = tuple(f.name for f in dataclasses.fields(DiFuserConfig))


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
    backend: str = "auto"        # "auto" | "single" | "serial"
    mu_v: int = 1                # vertex shards of the 2-D grid
    mu_s: int = 1                # sample-space (sim) shards
    partition: str = "block"     # vertex-assignment strategy (partition.plan)
    pad_mode: str = "step"       # "step" | "global" bucket padding
    fasst: bool = True           # FASST sample order (the serial ring always sorts)
    local_sweeps: int = 0        # comm-free sweeps before each ring sweep
    fuse_sweeps: bool = False    # run them as one fused_sweep call per shard
    lane_fill: int = 0           # register slab of the fused sweep (no effect here)
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

    @property
    def num_shards(self) -> int:
        """The shard grid's size (1 = unsharded)."""
        return max(self.mu_v, 1) * max(self.mu_s, 1)

    def difuser_config(self) -> DiFuserConfig:
        return DiFuserConfig(**{f: getattr(self, f) for f in _SKETCH_FIELDS})

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
