"""The benchmark's graphs: the Graph500 Kronecker generator, made on the
device from the run's seed.

This follows the Graph500 specification's reference generator
(``kronecker_generator.m``): each of the ``edgefactor * 2^SCALE`` edges
picks one quadrant per level with probabilities A, B, C and
``1 - A - B - C``, and the vertex labels are then permuted at random. The
benchmark drops self loops and repeated pairs itself, so that the program
and the plain reference receive the same host arrays, each edge with the
configuration's weight: a number for every edge, or ``"inverse_in_degree"``
for Kempe, Kleinberg and Tardos's Linear Threshold weights (KDD 2003, §4:
``c_uv / d_v`` with ``c_uv = 1`` on a simple graph, so that each vertex's
in-weights sum to 1). One ``torch.Generator`` on the device draws
everything, in a few large calls, so that set-up stays short and the same
seed gives the same graph on the same card.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def kronecker_edges(scale: int, edgefactor: int, a: float, b: float, c: float,
                    seed: int, device) -> Tuple[np.ndarray, np.ndarray]:
    """Distinct, loop-free edges ``(src, dst)`` (int64, sorted by (src, dst))
    of a Kronecker graph on ``2^scale`` vertices."""
    n, m = 1 << scale, edgefactor << scale
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ab = a + b
    a_norm, c_norm = a / ab, c / (1.0 - ab)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        low = torch.rand(m, generator=gen, device=device) > ab
        p_right = torch.where(low, c_norm, a_norm)
        right = torch.rand(m, generator=gen, device=device) > p_right
        src |= low.to(torch.int64) << level
        dst |= right.to(torch.int64) << level
    perm = torch.randperm(n, generator=gen, device=device)
    src, dst = perm[src], perm[dst]
    keep = src != dst
    key = torch.unique(src[keep] * n + dst[keep])
    key = key.cpu().numpy()
    return key // n, key % n


def edge_weights(n: int, dst: np.ndarray, weight) -> np.ndarray:
    """float32 weights of the edges into ``dst``: ``weight`` on every edge,
    or ``1 / in-degree(v)`` on each edge into v for ``"inverse_in_degree"``."""
    if weight == "inverse_in_degree":
        in_degree = np.bincount(dst, minlength=n)
        return (1.0 / in_degree[dst]).astype(np.float32)
    if isinstance(weight, str):
        raise ValueError(f"unknown weighting {weight!r}")
    return np.full(dst.shape[0], weight, dtype=np.float32)


def make_edges(config: dict, seed: int, device):
    """The configuration's graph from ``seed``: ``(n, src, dst, weight)``
    as host arrays."""
    if config["generator"] != "kronecker":
        raise ValueError(f"unknown generator {config['generator']!r}")
    n = 1 << config["scale"]
    src, dst = kronecker_edges(config["scale"], config["edgefactor"], config["a"],
                               config["b"], config["c"], seed, device)
    return n, src, dst, edge_weights(n, dst, config["weight"])
