"""Quickstart: find influential seeds in a small social graph with DiFuseR,
on the port (``repro_torch``).

    PYTHONPATH=src python examples_torch/quickstart.py                 # on the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu    # plain versions

It prints the lines of ``examples/quickstart.py``, with the same numbers.
"""
import argparse

import numpy as np

from repro_torch.baselines import influence_score
from repro_torch.device import resolve_device
from repro_torch.graphs import rmat_graph
from repro_torch.runtime import InfluenceSession, RunSpec

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                help="cuda runs the CUDA kernels; cpu their plain versions")
device = resolve_device(ap.parse_args().device)

# a power-law graph standing in for a social network (n=1024, ~8k edges)
graph = rmat_graph(10, edge_factor=8, seed=0, setting="w1")
print(f"graph: n={graph.n:,} vertices, m={graph.m_real:,} edges")

# DiFuseR with J=512 registers (one FM register per Monte-Carlo simulation);
# backend="auto" resolves the execution strategy for this environment
spec = RunSpec(num_registers=512, seed=0)
result = InfluenceSession(graph, spec, device=device).find_seeds(10)

print(f"seed set:          {result.seeds.tolist()}")
print(f"estimated spread:  {result.scores[-1]:.1f} vertices")
print(f"sketch rebuilds:   {int(result.rebuilds.sum())}/10 rounds (lazy rebuild, e=0.01)")

# validate against the independent Monte-Carlo oracle (paper §5.1)
oracle = influence_score(graph, result.seeds, num_sims=200)
print(f"oracle spread:     {oracle:.1f} vertices "
      f"(relative error {abs(oracle - result.scores[-1]) / oracle * 100:.1f}%)")

# FASST in action: the sorted random vector clusters correlated samples
from repro_torch.core.fasst import lane_fill_rate  # noqa: E402
from repro_torch.core.sampling import make_x_vector  # noqa: E402

x_unsorted = make_x_vector(512, seed=0)  # what a naive run would use
fill_naive = lane_fill_rate(graph, x_unsorted, device=device)
fill_fasst = lane_fill_rate(graph, np.sort(x_unsorted), device=device)
print(f"VPU lane fill:     naive {fill_naive*100:.0f}% -> FASST {fill_fasst*100:.0f}%")
