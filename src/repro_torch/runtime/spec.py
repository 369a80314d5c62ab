"""RunSpec: what to run. Its fields mirror ``core.difuser.DiFuserConfig``."""
from __future__ import annotations

import dataclasses

from repro_torch.core.difuser import DiFuserConfig
from repro_torch.diffusion.constants import DEFAULT_MODEL

_SKETCH_FIELDS = tuple(f.name for f in dataclasses.fields(DiFuserConfig))


@dataclasses.dataclass(frozen=True)
class RunSpec:
    num_registers: int = 1024
    seed: int = 0
    estimator: str = "hll"
    rebuild_threshold: float = 0.01
    max_propagate_iters: int = 64
    max_cascade_iters: int = 64
    sort_x: bool = True
    model: str = DEFAULT_MODEL

    def difuser_config(self) -> DiFuserConfig:
        return DiFuserConfig(**{f: getattr(self, f) for f in _SKETCH_FIELDS})
