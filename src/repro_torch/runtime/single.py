"""``single`` backend: the single-device Alg. 4 driver of core/difuser.py."""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.core import difuser as _difuser
from repro_torch.graphs.structs import Graph
from repro_torch.runtime.spec import RunSpec


@dataclasses.dataclass
class RunReport:
    result: _difuser.InfluenceResult
    spec: RunSpec
    device: str
    wall_s: float


def find_seeds(g: Graph, k: int, spec: RunSpec, *, x: Optional[np.ndarray] = None,
               device=None) -> RunReport:
    t0 = time.perf_counter()
    res = _difuser.find_seeds(g, k, spec.difuser_config(), x, device=device)
    return RunReport(result=res, spec=spec, device=str(_difuser.resolve_device(device)),
                     wall_s=time.perf_counter() - t0)
