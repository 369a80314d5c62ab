"""Monte-Carlo oracle (paper §5.1: a separate oracle without optimizations,
with many samples from a standard RNG, to verify the results).

A copy of the reference's ``baselines/mc_oracle.py`` on the port's graphs
and model zoo: numpy's PRNG, not the XOR-hash sampling it referees, and a
plain BFS per simulation. The same graph, seeds, model and ``rng_seed`` give
the same score as the reference, draw for draw.
"""
from __future__ import annotations

import numpy as np

from repro_torch.diffusion import resolve
from repro_torch.graphs.structs import CSR, Graph


def make_live_sampler(g: Graph, model: str):
    """A closure drawing bool[m_real] live-edge samples of ``g`` in the
    graph's edge order under ``model``, the model's host state made once."""
    sampler = resolve(model).mc_sampler(g)
    return lambda rng: sampler(rng)[: g.m_real]


def sample_live_mask(g: Graph, model: str, rng: np.random.Generator) -> np.ndarray:
    """One live-edge sample (bool[m_real], graph order) of ``g`` under
    ``model``: ``make_live_sampler`` drawn once."""
    return make_live_sampler(g, model)(rng)


def _bfs_reach(csr: CSR, sampled: np.ndarray, seeds: np.ndarray) -> int:
    """Number of vertices reachable from ``seeds`` over the sampled edges
    (``sampled``: bool[m] in CSR order)."""
    visited = np.zeros(csr.n, dtype=bool)
    visited[seeds] = True
    frontier = list(int(s) for s in np.unique(seeds))
    while frontier:
        new_frontier = []
        for u in frontier:
            lo, hi = csr.indptr[u], csr.indptr[u + 1]
            for v in csr.indices[lo:hi][sampled[lo:hi]]:
                if not visited[v]:
                    visited[v] = True
                    new_frontier.append(int(v))
        frontier = new_frontier
    return int(visited.sum())


def _draws(csr: CSR, g: Graph, model, rng, num_sims: int):
    """``num_sims`` live-edge samples in CSR order, one at a time. ``wc``
    keeps the reference's legacy draw (one uniform per edge in CSR order),
    so its RNG stream is the reference's."""
    if model in (None, "wc"):
        for _ in range(num_sims):
            yield rng.random(csr.weight.shape[0]) < csr.weight
    else:
        draw = make_live_sampler(g, model)
        for _ in range(num_sims):
            yield draw(rng)[csr.order]


def influence_score(g: Graph, seeds: np.ndarray, *, num_sims: int = 200,
                    rng_seed: int = 12345, model: str = "wc") -> float:
    """Expected influence of ``seeds`` under ``model`` by plain Monte-Carlo."""
    csr = g.csr()
    rng = np.random.default_rng(rng_seed)
    seeds = np.asarray(seeds, dtype=np.int64)
    total = sum(_bfs_reach(csr, sampled, seeds)
                for sampled in _draws(csr, g, model, rng, num_sims))
    return total / num_sims


def _cover(csr: CSR, sampled: np.ndarray, vis: np.ndarray, v: int) -> None:
    """Mark in ``vis`` everything ``v`` reaches over ``sampled`` (DFS)."""
    stack = [v]
    vis[v] = True
    while stack:
        u = stack.pop()
        for w_idx in range(csr.indptr[u], csr.indptr[u + 1]):
            if sampled[w_idx]:
                w = csr.indices[w_idx]
                if not vis[w]:
                    vis[w] = True
                    stack.append(int(w))


def exact_greedy(g: Graph, k: int, *, num_sims: int = 200, rng_seed: int = 999,
                 model: str = "wc") -> tuple[np.ndarray, float]:
    """Greedy over ``num_sims`` live-edge samples drawn once (Kempe et al.'s
    randomized greedy; small graphs only): each round takes the vertex of
    the largest marginal coverage, the first such vertex on ties."""
    csr = g.csr()
    rng = np.random.default_rng(rng_seed)
    n = csr.n
    sampled = list(_draws(csr, g, model, rng, num_sims))
    covered = [np.zeros(n, dtype=bool) for _ in range(num_sims)]
    seeds: list = []
    for _ in range(k):
        best_v, best_gain = -1, -1.0
        for v in range(n):
            if v in seeds:
                continue
            gain = 0
            for r in range(num_sims):
                if covered[r][v]:
                    continue
                vis = covered[r].copy()
                before = int(vis.sum())
                _cover(csr, sampled[r], vis, v)
                gain += int(vis.sum()) - before
            if gain > best_gain:
                best_gain, best_v = gain, v
        seeds.append(best_v)
        for r in range(num_sims):
            if not covered[r][best_v]:
                _cover(csr, sampled[r], covered[r], best_v)
    final = float(np.mean([c.sum() for c in covered]))
    return np.asarray(seeds, dtype=np.int32), final
