"""InfluenceSession: one object over the whole influence pipeline.

Counterpart of the reference's ``runtime/session.py``, host residency only.
A session binds a graph to a ``RunSpec`` once and offers the cold path
(``find_seeds``, ``build_sketch_matrix``) through the spec's backend and the
resident path (``entry``, ``find_seeds_warm``, ``apply_delta``) through a
``SketchStore``. It runs on CUDA unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import difuser as _difuser
from repro_torch.core.difuser import InfluenceResult
from repro_torch.device import resolve_device
from repro_torch.graphs.structs import Graph, GraphDelta
from repro_torch.runtime.base import Backend, RunReport, resolve_backend
from repro_torch.runtime.spec import RunSpec
from repro_torch.service.delta import DeltaReport, apply_delta
from repro_torch.service.store import SketchStore, StoreEntry


class InfluenceSession:
    """A graph bound to one ``RunSpec``. ``store`` shares a ``SketchStore``
    between sessions; by default the session owns one of ``num_banks``
    banks on its device, built through the session's spec."""

    def __init__(self, graph: Graph, spec: Optional[RunSpec] = None, *,
                 store: Optional[SketchStore] = None, num_banks: int = 1, device=None):
        self.graph = graph
        self.spec = spec if spec is not None else RunSpec()
        self.device = resolve_device(device)
        self.store = (store if store is not None
                      else SketchStore(num_banks=num_banks, spec=self.spec,
                                       device=self.device))
        self.last_report: Optional[RunReport] = None
        # store keys name the lineage graph (they outlive deltas), so the
        # session keeps its entry's key instead of deriving it again
        self._entry_key = None

    @property
    def backend(self) -> Backend:
        return resolve_backend(self.spec, self.graph)

    # -- cold path ----------------------------------------------------------

    def find_seeds(self, k: int, *, x: Optional[np.ndarray] = None,
                   plan=None) -> InfluenceResult:
        """Alg. 4 through the spec's backend; its ``RunReport`` is kept in
        ``last_report``."""
        report = self.backend.find_seeds(self.graph, k, self.spec, x=x, plan=plan,
                                         device=self.device)
        self.last_report = report
        return report.result

    def build_sketch_matrix(self, *, x: Optional[np.ndarray] = None, reg_offset: int = 0):
        """Alg. 4 lines 3-6 through the spec's backend: ``(matrix, iters,
        x_used)``, the matrix in the canonical layout."""
        cfg = self.spec.difuser_config()
        g, x_norm = _difuser.normalize_inputs(self.graph, cfg, x)
        m, iters = self.backend.build_matrix(g, self.spec, x_norm, reg_offset=reg_offset,
                                             normalized=True, device=self.device)
        return m, iters, x_norm

    # -- resident path ------------------------------------------------------

    def entry(self, *, x: Optional[np.ndarray] = None) -> StoreEntry:
        """The store's entry for this session's (graph, setting), built on
        first demand."""
        if x is None and self._entry_key is not None and self._entry_key in self.store:
            return self.store.entry(self._entry_key)
        e = self.store.get_or_build(self.graph, self.spec.difuser_config(), x)
        self._entry_key = e.key
        return e

    def find_seeds_warm(self, k: int, *, x: Optional[np.ndarray] = None) -> InfluenceResult:
        """The K seed rounds from the resident matrix, as engine-served
        ``TopKSeeds``: a stale entry is rebuilt first. The seeds equal
        ``find_seeds``'s."""
        from repro_torch.service.queries import top_k_seeds

        return top_k_seeds(self.store, self.entry(x=x), k)

    def apply_delta(self, delta: GraphDelta, *,
                    staleness_threshold: float = 0.1) -> DeltaReport:
        """Apply a graph delta to the resident entry through the session's
        backend: on ``serial`` (the shard-repair backend) with a plan
        attached, insertions sweep only the plan shards the delta dirtied.
        The session's graph follows the entry's, so the cold and the
        resident paths keep answering about the same graph."""
        e = self.entry()
        report = apply_delta(self.store, e.key, delta,
                             staleness_threshold=staleness_threshold,
                             backend=self.backend)
        self.graph = self.store.entry(e.key).graph
        return report
