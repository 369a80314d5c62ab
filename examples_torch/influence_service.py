"""Influence-as-a-service on the port: build the sketch index once, answer
~1k queries.

    PYTHONPATH=src python examples_torch/influence_service.py               # on the card
    PYTHONPATH=src python examples_torch/influence_service.py --device cpu  # plain versions

The cold path (``find_seeds``) pays fill + propagate-to-fixpoint on every
call. The service keeps the propagated register matrix resident in a
SketchStore, so top-k selection, spread estimates, and marginal gains are
register reductions — then repairs the index in place when the graph gains
edges. It prints the lines of ``examples/influence_service.py``.
"""
import argparse
import time

import numpy as np

from repro_torch.core.difuser import DiFuserConfig
from repro_torch.device import resolve_device
from repro_torch.graphs import rmat_graph
from repro_torch.graphs.structs import GraphDelta
from repro_torch.launch.serve_im import make_workload
from repro_torch.runtime import RunSpec, run as run_im
from repro_torch.service import (InfluenceEngine, SketchStore, TopKSeeds,
                                 apply_delta, summarize_latencies)

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                help="cuda runs the CUDA kernels; cpu their plain versions")
device = resolve_device(ap.parse_args().device)

graph = rmat_graph(12, edge_factor=8, seed=0, setting="w1")
print(f"graph: n={graph.n:,} vertices, m={graph.m_real:,} edges")
# explicit diffusion model id ("wc" = the backward-compatible default);
# the model is part of the SketchStore key, so one engine can serve
# ic/lt/dic indexes of the same graph side by side
config = DiFuserConfig(num_registers=512, seed=0, model="wc")

# --- cold baseline: one offline batch answer, full build every call -------
t0 = time.perf_counter()
cold = run_im(graph, 10, RunSpec.from_config(config), device=device).result
cold_s = time.perf_counter() - t0
print(f"cold find_seeds:   {cold_s:.2f}s -> seeds {cold.seeds[:5].tolist()}...")

# --- warm service: build once, then ~1k mixed queries ---------------------
store = SketchStore(device=device)
engine = InfluenceEngine(store)
key = engine.register(graph, config)
print(f"index build:       {store.entry(key).build_time_s:.2f}s (one-time)")

for q in make_workload(graph.n, 1000, k=10, seed=7):
    engine.submit(key, q)
t0 = time.perf_counter()
results = engine.run()
wall_s = time.perf_counter() - t0
stats = summarize_latencies(results)
print(f"1000 mixed queries: {wall_s:.2f}s "
      f"({1000 / wall_s:.0f} qps, p50 {stats['p50_ms']:.2f}ms, "
      f"p99 {stats['p99_ms']:.2f}ms)")
print(f"amortized:         {wall_s:.1f}ms/query vs {cold_s * 1e3:.0f}ms cold "
      f"-> {cold_s / (wall_s / 1000):.0f}x per query")

# warm top-k agrees with the cold run bit-for-bit
warm = engine(key, TopKSeeds(10)).value
assert np.array_equal(warm.seeds, cold.seeds), "warm top-k must match cold"
print(f"warm TopKSeeds == cold find_seeds: {warm.seeds[:5].tolist()}... ✓")

# --- the graph changes: repair the index instead of rebuilding ------------
rng = np.random.default_rng(1)
delta = GraphDelta.make(add=(rng.integers(0, graph.n, 64),
                             rng.integers(0, graph.n, 64)))
report = apply_delta(store, key, delta)
print(f"delta(+64 edges):  repaired in {report.time_s:.2f}s "
      f"({report.repair_sweeps} sweeps, {report.banks_touched} bank(s)) "
      f"vs {store.entry(key).build_time_s:.2f}s rebuild")
fresh = engine(key, TopKSeeds(10)).value
print(f"post-delta top-10: {fresh.seeds[:5].tolist()}...")

# --- mixed-model traffic: one engine, distinct store keys per model --------
lt_key = engine.register(graph, DiFuserConfig(num_registers=512, seed=0, model="lt"))
assert lt_key != key, "model id must separate store keys"
lt_top = engine(lt_key, TopKSeeds(10)).value
print(f"lt model top-10:   {lt_top.seeds[:5].tolist()}... "
      f"({len(store)} model-keyed indexes resident)")
