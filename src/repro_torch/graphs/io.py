"""SNAP edge-list loader (numpy), a copy of the reference ``graphs/io.py``
loader."""
from __future__ import annotations

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
