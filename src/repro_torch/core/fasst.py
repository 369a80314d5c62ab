"""FASST, fusing-aware sample-space tasking (paper §4.1), and its metrics
(paper Tables 5-7).

Counterpart of the reference's ``core/fasst.py``. Sorting X keeps each sim
shard's contiguous chunk of samples on a small edge subset: that subset is
the shard's device-local graph, so the shards overlap less (Table 5), their
lanes fill better (Table 6) and the largest of them, which bounds a
straggler, shrinks (Table 7).

``partition_samples`` and ``max_shard_fraction`` are host numpy.
``sampled_by_any``, and through it ``build_partition`` and
``duplication_histogram``, run ``kernels.ops.fused_sample`` on the operands'
device in edge chunks; ``lane_fill_rate`` reads its mask too. The analysis
functions take ``device`` (CUDA unless ``"cpu"`` is passed).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sampling import INTERVAL, edge_hash, weight_to_threshold
from repro_torch.core.sketch import pad_x
from repro_torch.device import resolve_device
from repro_torch.graphs.structs import Graph
from repro_torch.kernels import ops

#: edges per ``fused_sample`` launch: 512 MiB of mask at 512 samples
SAMPLE_CHUNK = 1 << 20


@dataclasses.dataclass(frozen=True)
class SamplePartition:
    """The sample space split over ``mu`` shards (host numpy).

    x_shards:    uint32[mu, J_loc]  each shard's X slice.
    perm:        int32[R]           original sim id of each (shard, slot).
    edge_index:  int32[mu, E_max]   each shard's sampled edge ids, ascending,
                                    padded with the inert sentinel edge
                                    ``g.m - 1`` to a multiple of the edge block.
    edge_counts: int64[mu]          each shard's sampled edge count.
    method:      "fasst" | "naive".
    """

    x_shards: np.ndarray
    perm: np.ndarray
    edge_index: np.ndarray
    edge_counts: np.ndarray
    method: str

    @property
    def mu(self) -> int:
        return self.x_shards.shape[0]

    @property
    def regs_per_shard(self) -> int:
        return self.x_shards.shape[1]


def partition_samples(x: np.ndarray, mu: int, *, method: str = "fasst"):
    """Split R samples into ``mu`` equal shards. ``fasst``: contiguous chunks
    of the sorted vector; ``naive``: the original order. Returns
    ``(x_shards uint32[mu, R / mu], perm int32[R])`` with
    ``perm[shard * J_loc + slot]`` the original simulation id."""
    r = x.shape[0]
    if r % mu:
        raise ValueError(f"{r} samples do not split into {mu} shards")
    if method == "fasst":
        perm = np.argsort(x, kind="stable").astype(np.int32)
    elif method == "naive":
        perm = np.arange(r, dtype=np.int32)
    else:
        raise ValueError(method)
    return x[perm].reshape(mu, r // mu), perm


def sampled_by_any(h: torch.Tensor, lo: torch.Tensor, thr: torch.Tensor,
                   x: torch.Tensor, *, variant: int,
                   chunk_edges: int = SAMPLE_CHUNK) -> torch.Tensor:
    """``bool[E]``: edge e is live under at least one sample of ``x``
    (int32[R] uint32 bits), on the operands' device. x is padded to the
    kernels' sample count; the padding samples' columns of each mask chunk
    are dropped before the OR."""
    num_samples = x.shape[0]
    xp = pad_x(x, num_samples)
    out = torch.empty(h.shape[0], dtype=torch.bool, device=h.device)
    for a in range(0, h.shape[0], chunk_edges):
        b = a + chunk_edges
        mask = ops.fused_sample(h[a:b], lo[a:b], thr[a:b], xp, variant=variant)
        out[a:b] = mask[:, :num_samples].any(dim=1)
    return out


def _bits(a: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy -> int32 tensor of the same bits on ``device``."""
    return torch.from_numpy(np.require(a, np.uint32, ["C", "W"]).view(np.int32)).to(device)


def _shard_masks(h, lo, thr, x_shards: np.ndarray, variant: int, device) -> list:
    return [sampled_by_any(h, lo, thr, _bits(x_shards[t], device), variant=variant)
            for t in range(x_shards.shape[0])]


def build_partition(g: Graph, x: np.ndarray, mu: int, *, method: str = "fasst",
                    seed: int = 0, edge_block: int = 256, model: str = "wc",
                    device=None) -> SamplePartition:
    """Each sample shard's device-local edge list (paper §4, setup lines
    1-3): exactly the edges at least one of its samples makes live under
    ``model``'s predicate (``fused_sample`` on ``device``), padded to a
    common length, a multiple of ``edge_block``, with the sentinel edge
    ``g.m - 1`` (a padding edge, ``thr == 0``). The common length is the
    paper's Table 7 metric."""
    from repro_torch.diffusion import resolve as resolve_model

    dev = resolve_device(device)
    x_shards, perm = partition_samples(np.asarray(x, dtype=np.uint32), mu, method=method)
    mdl = resolve_model(model)
    ep = mdl.edge_params(g, seed=seed)
    sentinel_edge = g.m - 1
    if ep.thr[sentinel_edge] != 0:
        raise ValueError("graph must carry at least one padding edge")
    masks = _shard_masks(_bits(ep.h, dev), _bits(ep.lo, dev), _bits(ep.thr, dev), x_shards,
                         mdl.variant, dev)
    ids = [torch.nonzero(msk).flatten().to(torch.int32).cpu().numpy() for msk in masks]
    counts = np.array([a.shape[0] for a in ids], dtype=np.int64)
    e_max = max(int(counts.max()) if counts.size else 0, 1)
    e_max += (-e_max) % edge_block
    edge_index = np.full((mu, e_max), sentinel_edge, dtype=np.int32)
    for t, a in enumerate(ids):
        edge_index[t, : a.shape[0]] = a
    return SamplePartition(x_shards=x_shards, perm=perm, edge_index=edge_index,
                           edge_counts=counts, method=method)


# -- the metrics (paper Tables 5, 6, 7) ------------------------------------------------

def duplication_histogram(g: Graph, part: SamplePartition, *, seed: int = 0,
                          device=None) -> np.ndarray:
    """Table 5: the fraction of real edges in exactly k device-local graphs,
    k = 0..mu, float64. As the reference's, it samples with the legacy wc
    compare (the graph's weights, lo = 0), whatever model built ``part``."""
    dev = resolve_device(device)
    thr = _bits(weight_to_threshold(g.weight), dev)
    masks = _shard_masks(_bits(edge_hash(g.src, g.dst, seed=seed), dev),
                         torch.zeros_like(thr), thr, part.x_shards, INTERVAL, dev)
    appear = torch.stack(masks).to(torch.int32).sum(dim=0)[: g.m_real].cpu().numpy()
    hist = np.bincount(appear, minlength=part.mu + 1).astype(np.float64)
    return hist / max(g.m_real, 1)


def max_shard_fraction(g: Graph, part: SamplePartition) -> float:
    """Table 7: the largest device-local edge count over the real edges."""
    return float(part.edge_counts.max() / max(g.m_real, 1))


def lane_fill_rate(g: Graph, x_sorted_or_not: np.ndarray, *, lane_width: int = 128,
                   seed: int = 0, max_edges: int = 1 << 15, device=None) -> float:
    """Table 6: the useful share of the lanes of every touched lane tile.

    Over the first ``max_edges`` real edges, each (edge, tile of
    ``lane_width`` consecutive samples) with at least one sampled lane counts
    its sampled lanes over ``lane_width``; the mask is ``fused_sample``'s
    under the legacy wc compare (lo = 0). ``lane_width=32``, a warp, is the
    paper's metric; the default 128 is the reference's (a TPU lane tile)."""
    r = x_sorted_or_not.shape[0]
    if r % lane_width:
        raise ValueError(f"{r} samples do not split into lane tiles of {lane_width}")
    dev = resolve_device(device)
    real = g.m_real
    eh = _bits(edge_hash(g.src[:real], g.dst[:real], seed=seed)[:max_edges], dev)
    thr = _bits(weight_to_threshold(g.weight)[:real][:max_edges], dev)
    lo = torch.zeros_like(thr)
    x = pad_x(_bits(np.asarray(x_sorted_or_not, dtype=np.uint32), dev), r)
    sampled_slots = active_tiles = 0
    chunk = max(1, (1 << 22) // r)
    for a in range(0, eh.shape[0], chunk):
        b = min(a + chunk, eh.shape[0])
        mask = ops.fused_sample(eh[a:b], lo[a:b], thr[a:b], x, variant=INTERVAL)
        tiles = mask[:, :r].reshape(b - a, r // lane_width, lane_width)
        sampled_slots += int(tiles.sum(dtype=torch.int64).item())
        active_tiles += int(tiles.any(dim=2).sum().item())
    if active_tiles == 0:
        return 0.0
    return sampled_slots / (active_tiles * lane_width)
