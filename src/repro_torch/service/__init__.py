"""Influence query service of the port, synchronous and host-resident: the
persistent sketch store, the four query classes, the batched engine and the
incremental repair of graph deltas."""
from repro_torch.service.delta import DeltaReport, apply_delta
from repro_torch.service.engine import (InfluenceEngine, QueryResult, Request,
                                        summarize_latencies)
from repro_torch.service.queries import (CoverageProbe, MarginalGain, SpreadEstimate,
                                         TopKSeeds)
from repro_torch.service.store import SketchStore, StoreEntry, StoreKey

__all__ = [
    "SketchStore", "StoreEntry", "StoreKey",
    "TopKSeeds", "SpreadEstimate", "MarginalGain", "CoverageProbe",
    "InfluenceEngine", "QueryResult", "Request", "summarize_latencies",
    "DeltaReport", "apply_delta",
]
