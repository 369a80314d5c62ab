"""Graph IO (numpy), a copy of the reference ``graphs/io.py``: the SNAP
edge-list loader and the npz cache of a built graph."""
from __future__ import annotations

import os

import numpy as np

from repro_torch.graphs.generators import edge_weights, make_wc_weights
from repro_torch.graphs.structs import Graph


def load_snap_edgelist(path: str, *, setting: str = "w1", directed: bool = True,
                       seed: int = 0, edge_block: int = 256) -> Graph:
    """Parse a whitespace edge list (``#``/``%`` comments). Vertex ids are
    compacted to [0, n); undirected inputs are symmetrized. ``setting`` is
    one of the paper's five influence settings, or ``wc``."""
    src_l: list[int] = []
    dst_l: list[int] = []
    with open(path) as f:
        for line in f:
            if line.startswith(("#", "%")):
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            src_l.append(int(parts[0]))
            dst_l.append(int(parts[1]))
    src = np.asarray(src_l, dtype=np.int64)
    dst = np.asarray(dst_l, dtype=np.int64)
    ids = np.unique(np.concatenate([src, dst]))
    src = np.searchsorted(ids, src).astype(np.int64)
    dst = np.searchsorted(ids, dst).astype(np.int64)
    n = int(ids.size)
    if not directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    if setting == "wc":
        w = make_wc_weights(n, dst)
    else:
        w = edge_weights(setting, src.shape[0], seed=seed)
    return Graph.from_edges(n, src, dst, w, edge_block=edge_block)


def save_npz(path: str, g: Graph) -> None:
    """Write ``g`` (sizes and edge arrays) to a compressed npz, the
    reference's layout."""
    np.savez_compressed(path, n=g.n, n_pad=g.n_pad, m_real=g.m_real, src=g.src,
                        dst=g.dst, weight=g.weight)


def load_npz(path: str) -> Graph:
    """The graph ``save_npz`` wrote (either package's)."""
    z = np.load(path)
    return Graph(n=int(z["n"]), src=z["src"], dst=z["dst"], weight=z["weight"],
                 n_pad=int(z["n_pad"]), m_real=int(z["m_real"]))


def cached(path: str, builder) -> Graph:
    """``load_npz(path)`` where the file exists, else ``builder()`` saved
    there first."""
    if os.path.exists(path):
        return load_npz(path)
    g = builder()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_npz(path, g)
    return g
