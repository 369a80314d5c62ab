"""Synthetic graph generators (numpy, deterministic from a seed).

Copies of the reference package's ``graphs/generators.py``: the same seed
gives the same graph in both packages. Weight settings are the paper's five
influence settings (§5): const 0.005 / 0.01 / 0.1, N(0.05, 0.025),
U(0, 0.1).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.structs import Graph

PAPER_SETTINGS = ("w005", "w01", "w1", "n005", "u01")


def edge_weights(setting: str, m: int, seed: int = 0) -> np.ndarray:
    """The paper's five influence settings (§5)."""
    rng = np.random.default_rng(seed)
    if setting in ("w005", "0.005"):
        return np.full(m, 0.005, dtype=np.float32)
    if setting in ("w01", "0.01"):
        return np.full(m, 0.01, dtype=np.float32)
    if setting in ("w1", "0.1"):
        return np.full(m, 0.1, dtype=np.float32)
    if setting in ("n005", "N0.05"):
        return np.clip(rng.normal(0.05, 0.025, m), 0.0, 1.0).astype(np.float32)
    if setting in ("u01", "U0.1"):
        return rng.uniform(0.0, 0.1, m).astype(np.float32)
    if setting == "wc":
        raise ValueError("weighted-cascade weights are derived from the graph; "
                         "use make_wc_weights")
    raise ValueError(f"unknown influence setting: {setting}")


def make_wc_weights(n: int, dst: np.ndarray) -> np.ndarray:
    """Weighted-cascade weights: w_uv = 1 / indegree(v)."""
    indeg = np.bincount(dst, minlength=n).astype(np.float32)
    return (1.0 / np.maximum(indeg, 1.0))[dst]


def rmat_graph(scale: int, edge_factor: int = 16, *, a: float = 0.57,
               b: float = 0.19, c: float = 0.19, seed: int = 0,
               setting: str = "w1", directed: bool = True,
               edge_block: int = 256, permute_ids: bool = True) -> Graph:
    """R-MAT generator (Graph500 parameters), n = 2**scale vertices.
    ``permute_ids=False`` keeps the raw Kronecker ids (hubs at low ids)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        right = rng.random(m) >= ab
        r2 = rng.random(m)
        col_top = r2 >= (a / ab)
        col_bot = r2 >= (c / (1.0 - ab)) if abc < 1.0 else np.zeros(m, bool)
        col = np.where(right, col_bot, col_top)
        src = (src << 1) | right.astype(np.int64)
        dst = (dst << 1) | col.astype(np.int64)
    # the permutation is drawn either way, so both variants share a topology
    perm = rng.permutation(n)
    if permute_ids:
        src, dst = perm[src], perm[dst]
    if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    w = edge_weights(setting, src.shape[0], seed=seed + 1)
    return Graph.from_edges(n, src, dst, w, edge_block=edge_block)


def erdos_renyi_graph(n: int, avg_degree: float = 8.0, *, seed: int = 0,
                      setting: str = "w1", directed: bool = True,
                      edge_block: int = 256) -> Graph:
    m = int(n * avg_degree)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    w = edge_weights(setting, src.shape[0], seed=seed + 1)
    return Graph.from_edges(n, src, dst, w, edge_block=edge_block)


def barabasi_albert_graph(n: int, m_attach: int = 4, *, seed: int = 0,
                          setting: str = "w1", edge_block: int = 256) -> Graph:
    """Preferential attachment, symmetrized."""
    rng = np.random.default_rng(seed)
    targets = list(range(m_attach))
    repeated: list[int] = list(range(m_attach))
    src_l: list[int] = []
    dst_l: list[int] = []
    for v in range(m_attach, n):
        for t in targets:
            src_l.append(v)
            dst_l.append(t)
        repeated.extend(targets)
        repeated.extend([v] * m_attach)
        idx = rng.integers(0, len(repeated), m_attach)
        targets = [repeated[i] for i in idx]
    src = np.array(src_l + dst_l, dtype=np.int64)
    dst = np.array(dst_l + src_l, dtype=np.int64)
    w = edge_weights(setting, src.shape[0], seed=seed + 1)
    return Graph.from_edges(n, src, dst, w, edge_block=edge_block)
