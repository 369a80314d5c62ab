"""RIS/IMM baseline (the algorithm behind gIM and cuRipples, the paper's two
competitors), host numpy, a copy of the reference's ``baselines/ris.py``.

Reverse Influence Sampling: draw reverse-reachable (RR) sets, each from a
uniform random root by a backward BFS over IC-sampled in-edges, then pick K
seeds greedily to cover the most RR sets. IMM's bound chooses how many RR
sets to draw (``imm_num_rr_sets``), or the caller fixes the count.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.graphs.structs import Graph


def _reverse_csr(g: Graph):
    src = g.src[: g.m_real]
    dst = g.dst[: g.m_real]
    w = g.weight[: g.m_real]
    order = np.argsort(dst, kind="stable")
    dst_s, src_s, w_s = dst[order], src[order], w[order]
    counts = np.bincount(dst_s, minlength=g.n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return indptr, src_s.astype(np.int64), w_s


def _sample_rr_set(indptr, indices, weight, root: int, rng) -> np.ndarray:
    """One reverse-reachable set from ``root``, each in-edge drawn on the way."""
    visited = {root}
    stack = [root]
    while stack:
        v = stack.pop()
        lo, hi = indptr[v], indptr[v + 1]
        if hi == lo:
            continue
        take = rng.random(hi - lo) < weight[lo:hi]
        for u in indices[lo:hi][take]:
            if u not in visited:
                visited.add(int(u))
                stack.append(int(u))
    return np.fromiter(visited, dtype=np.int64)


def imm_num_rr_sets(n: int, k: int, epsilon: float = 0.5, ell: float = 1.0) -> int:
    """IMM's count of RR sets, simplified (Tang et al., eq. 9), at least 256."""
    lognk = math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
    alpha = math.sqrt(ell * math.log(n) + math.log(2))
    beta = math.sqrt((1 - 1 / math.e) * (lognk + ell * math.log(n) + math.log(2)))
    lam = 2 * n * ((1 - 1 / math.e) * alpha + beta) ** 2 / (epsilon ** 2)
    return max(int(lam / n), 256)


def ris_find_seeds(g: Graph, k: int, *, epsilon: float = 0.5,
                   num_rr_sets: int | None = None, rng_seed: int = 7,
                   max_rr_sets: int = 200_000) -> tuple[np.ndarray, float]:
    """Greedy max-cover over RR sets. Returns (seeds, covered fraction x n,
    an unbiased influence estimate)."""
    indptr, indices, weight = _reverse_csr(g)
    rng = np.random.default_rng(rng_seed)
    theta = num_rr_sets if num_rr_sets is not None else min(
        imm_num_rr_sets(g.n, k, epsilon), max_rr_sets)
    rr_sets = []
    member_of: list[list[int]] = [[] for _ in range(g.n)]
    for i in range(theta):
        root = int(rng.integers(0, g.n))
        rr = _sample_rr_set(indptr, indices, weight, root, rng)
        rr_sets.append(rr)
        for u in rr:
            member_of[u].append(i)

    cover_count = np.zeros(g.n, dtype=np.int64)
    for rr in rr_sets:
        cover_count[rr] += 1
    covered = np.zeros(theta, dtype=bool)
    seeds = []
    for _ in range(k):
        s = int(np.argmax(cover_count))
        seeds.append(s)
        for i in member_of[s]:
            if not covered[i]:
                covered[i] = True
                for u in rr_sets[i]:
                    cover_count[u] -= 1
    est_influence = float(covered.sum()) / theta * g.n
    return np.asarray(seeds, dtype=np.int32), est_influence
