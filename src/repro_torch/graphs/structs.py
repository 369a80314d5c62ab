"""Graph container of the port (numpy, host side; ``Graph.sorted_by_dst``
may sort on a torch device).

A copy of the reference package's ``graphs/structs.py`` (``Graph``,
``GraphDelta``, ``CSR``, ``edge_pair_keys``), kept here so that the port
imports nothing of the reference package: the same inputs give byte-equal
arrays and the same ``content_key``.

Padding convention (identical to the reference): edge arrays are padded to a
multiple of ``edge_block`` with sentinel edges ``(n_pad-1, n_pad-1, w=0)``.
Weight zero gives threshold zero, so a sentinel edge never fires.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np

INT = np.int32


def edge_pair_keys(src: np.ndarray, dst: np.ndarray, n_pad: int) -> np.ndarray:
    """Collision-free int64 key of (u, v) pairs with u, v < n_pad, shared by
    removal matching and delta repair."""
    return src.astype(np.int64) * np.int64(n_pad) + dst.astype(np.int64)


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

    def with_weights(self, weight: np.ndarray) -> "Graph":
        """Replace the real edges' weights (padding stays 0)."""
        w = np.zeros_like(self.weight)
        w[: self.m_real] = np.asarray(weight, dtype=np.float32)[: self.m_real]
        return dataclasses.replace(self, weight=w)

    def sorted_by_dst(self, device=None) -> "Graph":
        """Real edges sorted by (dst, src), padding kept at the end.

        Without a ``device`` the order is the host's ``np.lexsort``. With a
        torch ``device`` it is a stable sort of the int64 key
        ``dst * n_pad + src`` there (``n_pad < 2^31``, so the key cannot
        overflow), which gives ``lexsort``'s order, ties among repeated pairs
        included: the same arrays, byte for byte. The edges go up once and
        come back as one int32 ``[3, m]`` block (``dst_sort_bytes``), whose
        rows are the new ``src``, ``dst`` and ``weight``; the device's
        temporaries are freed on return."""
        r = self.m_real
        if device is None:
            order = np.lexsort((self.src[:r], self.dst[:r]))
            src = np.concatenate([self.src[:r][order], self.src[r:]])
            dst = np.concatenate([self.dst[:r][order], self.dst[r:]])
            w = np.concatenate([self.weight[:r][order], self.weight[r:]])
            return dataclasses.replace(self, src=src, dst=dst, weight=w)
        import torch

        if (self.src.dtype, self.dst.dtype, self.weight.dtype) != (INT, INT, np.float32):
            raise TypeError("a device sort takes int32 ids and float32 weights, not "
                            f"{self.src.dtype}, {self.dst.dtype}, {self.weight.dtype}")
        cols = [torch.from_numpy(np.require(a, None, ["C", "W"])).to(device)
                for a in (self.src, self.dst, self.weight.view(INT))]
        key = cols[1][:r].long() * self.n_pad + cols[0][:r]
        order = torch.sort(key, stable=True).indices
        del key
        perm = torch.cat([order, torch.arange(r, self.m, device=order.device)])
        del order
        block = torch.stack(cols).index_select(1, perm)
        if block.is_cuda:
            # page-locked memory that torch's host allocator keeps from one
            # call to the next: the copy back runs at the bus's rate, with
            # no page faults
            block = torch.empty(block.shape, dtype=block.dtype,
                                pin_memory=True).copy_(block)
        block = block.numpy()
        return dataclasses.replace(self, src=block[0], dst=block[1],
                                   weight=block[2].view(np.float32))

    def dst_sort_bytes(self, device) -> int:
        """Bytes that ``sorted_by_dst(device)`` copies between the host and
        the device: the edge arrays up and the sorted block back, none where
        the device is the CPU."""
        import torch

        if torch.device(device).type == "cpu":
            return 0
        return 2 * (self.src.nbytes + self.dst.nbytes + self.weight.nbytes)

    def reverse(self) -> "Graph":
        """The transposed graph: every edge's endpoints swapped."""
        return dataclasses.replace(self, src=self.dst.copy(), dst=self.src.copy())

    def csr(self) -> "CSR":
        return CSR.from_graph(self)

    def content_key(self) -> str:
        """Stable hash of the real edge set (order-insensitive): the graph
        part of a ``service.store.StoreKey``."""
        r = self.m_real
        src = self.src[:r].astype(np.int64)
        dst = self.dst[:r].astype(np.int64)
        w = self.weight[:r].astype(np.float32)
        order = np.lexsort((dst, src))
        h = hashlib.blake2b(digest_size=12)
        h.update(np.int64(self.n).tobytes())
        h.update(src[order].tobytes())
        h.update(dst[order].tobytes())
        h.update(w[order].tobytes())
        return h.hexdigest()

    def apply_delta(self, delta: "GraphDelta", *, edge_block: int = 256) -> "Graph":
        """The updated graph: every (u, v) pair named in the removals dropped,
        the added edges appended, padded again. Added edges that repeat a
        surviving pair merge with compound probability (``from_edges``)."""
        r = self.m_real
        src = self.src[:r].astype(np.int64)
        dst = self.dst[:r].astype(np.int64)
        w = self.weight[:r]
        if delta.rem_src.size:
            keep = ~np.isin(edge_pair_keys(src, dst, self.n_pad),
                            edge_pair_keys(delta.rem_src, delta.rem_dst, self.n_pad))
            src, dst, w = src[keep], dst[keep], w[keep]
        if delta.add_src.size:
            src = np.concatenate([src, delta.add_src.astype(np.int64)])
            dst = np.concatenate([dst, delta.add_dst.astype(np.int64)])
            w = np.concatenate([w, delta.add_weight.astype(np.float32)])
        return Graph.from_edges(self.n, src, dst, w, edge_block=edge_block)


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """A batch of edge insertions and removals against a Graph. Vertex ids
    lie in ``[0, n)`` of the target graph (the vertex set is fixed); a
    removal matches every parallel (u, v) edge whatever its weight."""

    add_src: np.ndarray     # int64[a]
    add_dst: np.ndarray     # int64[a]
    add_weight: np.ndarray  # float32[a]
    rem_src: np.ndarray     # int64[r]
    rem_dst: np.ndarray     # int64[r]

    @staticmethod
    def make(add=None, remove=None, default_weight: float = 0.1) -> "GraphDelta":
        """``add``: (src, dst[, weight]) arrays; ``remove``: (src, dst)."""
        empty_i = np.zeros(0, dtype=np.int64)
        if add is None:
            a_src, a_dst, a_w = empty_i, empty_i, np.zeros(0, dtype=np.float32)
        else:
            a_src = np.asarray(add[0], dtype=np.int64)
            a_dst = np.asarray(add[1], dtype=np.int64)
            a_w = (np.asarray(add[2], dtype=np.float32) if len(add) > 2
                   else np.full(a_src.shape, default_weight, dtype=np.float32))
        if remove is None:
            r_src, r_dst = empty_i, empty_i
        else:
            r_src = np.asarray(remove[0], dtype=np.int64)
            r_dst = np.asarray(remove[1], dtype=np.int64)
        return GraphDelta(add_src=a_src, add_dst=a_dst, add_weight=a_w,
                          rem_src=r_src, rem_dst=r_dst)

    @property
    def num_added(self) -> int:
        return int(self.add_src.size)

    @property
    def num_removed(self) -> int:
        return int(self.rem_src.size)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Row-pointer adjacency over the real edges (host side, for the
    Monte-Carlo oracle). ``order`` maps the graph's real-edge order to CSR
    order: per-edge data drawn in graph order maps over as ``data[order]``."""

    n: int
    indptr: np.ndarray   # int64[n + 1]
    indices: np.ndarray  # int32[m_real]
    weight: np.ndarray   # float32[m_real]
    order: Optional[np.ndarray] = None  # int64[m_real]

    @staticmethod
    def from_graph(g: Graph) -> "CSR":
        src = g.src[: g.m_real]
        dst = g.dst[: g.m_real]
        w = g.weight[: g.m_real]
        order = np.argsort(src, kind="stable")
        src_s, dst_s, w_s = src[order], dst[order], w[order]
        counts = np.bincount(src_s, minlength=g.n)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return CSR(n=g.n, indptr=indptr, indices=dst_s.astype(INT), weight=w_s,
                   order=order)

    def neighbors(self, u: int) -> np.ndarray:
        """u's out-neighbours."""
        return self.indices[self.indptr[u]: self.indptr[u + 1]]

    def neighbor_weights(self, u: int) -> np.ndarray:
        """The weights of u's out-edges, in ``neighbors(u)``'s order."""
        return self.weight[self.indptr[u]: self.indptr[u + 1]]
