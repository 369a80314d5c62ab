"""Influence query service of the port, host-resident: the persistent sketch
store, the four query classes, the batched engine, the incremental repair of
graph deltas, and the async admission path (deadline-driven micro-batching,
double-buffered builds and repairs, cost-aware eviction)."""
from repro_torch.service.async_engine import AsyncInfluenceEngine
from repro_torch.service.delta import DeltaReport, apply_delta
from repro_torch.service.engine import (InfluenceEngine, QueryResult, Request,
                                        summarize_latencies)
from repro_torch.service.eviction import CostAwareEvictor
from repro_torch.service.queries import (CoverageProbe, MarginalGain, SpreadEstimate,
                                         TopKSeeds)
from repro_torch.service.scheduler import AsyncRequest, MicroBatchScheduler
from repro_torch.service.store import EvictionRecipe, SketchStore, StoreEntry, StoreKey

__all__ = [
    "SketchStore", "StoreEntry", "StoreKey", "EvictionRecipe",
    "TopKSeeds", "SpreadEstimate", "MarginalGain", "CoverageProbe",
    "InfluenceEngine", "QueryResult", "Request", "summarize_latencies",
    "DeltaReport", "apply_delta",
    "AsyncInfluenceEngine", "MicroBatchScheduler", "AsyncRequest",
    "CostAwareEvictor",
]
