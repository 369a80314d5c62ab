"""Graph container of the port (numpy, host side).

A copy of the parts of the reference package's ``graphs/structs.py`` that
the single-device path uses (``Graph.from_edges`` and ``sorted_by_dst``),
kept here so that the port imports nothing of the reference package.

Padding convention (identical to the reference): edge arrays are padded to a
multiple of ``edge_block`` with sentinel edges ``(n_pad-1, n_pad-1, w=0)``.
Weight zero gives threshold zero, so a sentinel edge never fires.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

INT = np.int32


def pad_to_multiple(x: np.ndarray, multiple: int, fill) -> np.ndarray:
    """Pad 1-D array ``x`` up to a multiple of ``multiple`` with ``fill``."""
    rem = (-x.shape[0]) % multiple
    if rem == 0:
        return x
    return np.concatenate([x, np.full((rem,), fill, dtype=x.dtype)])


@dataclasses.dataclass(frozen=True)
class Graph:
    """Directed graph in COO form with per-edge diffusion probabilities.

    n: real vertices; src, dst: int32[m] endpoints (padding included);
    weight: float32[m] in [0, 1], 0 for padding; n_pad: padded vertex count
    (>= n + 1, the sentinel vertex is n_pad - 1); m_real: real edges.
    """

    n: int
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    n_pad: int
    m_real: int

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    @staticmethod
    def from_edges(n: int, src: np.ndarray, dst: np.ndarray,
                   weight: Optional[np.ndarray] = None, *,
                   edge_block: int = 256, vertex_multiple: int = 8,
                   dedup: bool = True) -> "Graph":
        """Build a padded Graph from raw COO arrays. Parallel (u, v)
        duplicates merge with probability ``1 - prod(1 - w_i)``; self loops
        are dropped."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if weight is None:
            weight = np.full(src.shape, 0.1, dtype=np.float32)
        weight = np.asarray(weight, dtype=np.float32)
        keep = src != dst
        src, dst, weight = src[keep], dst[keep], weight[keep]

        if dedup and src.size:
            key = src * np.int64(n) + dst
            order = np.argsort(key, kind="stable")
            key, src, dst, weight = key[order], src[order], dst[order], weight[order]
            uniq, start = np.unique(key, return_index=True)
            if uniq.size != key.size:
                log1m = np.log1p(-np.clip(weight, 0.0, 0.999999))
                csum = np.concatenate([[0.0], np.cumsum(log1m)])
                ends = np.concatenate([start[1:], [key.size]])
                merged_w = 1.0 - np.exp(csum[ends] - csum[start])
                src, dst = src[start], dst[start]
                weight = merged_w.astype(np.float32)

        m_real = int(src.size)
        n_pad = n + 1
        n_pad += (-n_pad) % vertex_multiple
        sentinel = n_pad - 1
        src = pad_to_multiple(src.astype(INT), edge_block, INT(sentinel))
        dst = pad_to_multiple(dst.astype(INT), edge_block, INT(sentinel))
        weight = pad_to_multiple(weight, edge_block, np.float32(0.0))
        return Graph(n=n, src=src, dst=dst, weight=weight, n_pad=n_pad,
                     m_real=m_real)

    def sorted_by_dst(self) -> "Graph":
        """Real edges sorted by (dst, src), padding kept at the end."""
        r = self.m_real
        order = np.lexsort((self.src[:r], self.dst[:r]))
        src = np.concatenate([self.src[:r][order], self.src[r:]])
        dst = np.concatenate([self.dst[:r][order], self.dst[r:]])
        w = np.concatenate([self.weight[:r][order], self.weight[r:]])
        return dataclasses.replace(self, src=src, dst=dst, weight=w)
