"""The 2-D partition build: plan -> bucketed, padded arrays on the device.

Counterpart of the reference's ``partition/builder.py``: the FASST sample
split (``mu_s`` sim shards) times the planned vertex split (``mu_v`` vertex
shards), every sampled edge of sim shard s put in the bucket of its write
shard v and ring step kk (at step kk, shard v reads the register block of
shard ``(v + kk) % mu_v``). Per step, the buckets are padded to one width:
``"step"`` pads each step to its own widest bucket, ``"global"`` every step
to one width. Padding slots are zeros (``thr = 0`` never fires). Within a
bucket the slots are in ascending edge id.

The sort and the scatter run with torch on the device of ``sampled`` and
give the reference's arrays byte for byte: ``p_h[kk]`` is ``(mu_v, mu_s,
B_kk)``, with the uint32 arrays (h, t, l) held as int32 bit patterns.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.graphs.structs import Graph
from repro_torch.obs import trace
from repro_torch.partition.plan import (PartitionPlan, SampledEdges, plan_partition,
                                        sample_edge_sets)


@dataclasses.dataclass(frozen=True)
class Partition2D:
    """Everything the ring sweeps consume, bucketed and padded."""

    n: int
    n_pad: int                 # padded so mu_v | n_pad
    n_loc: int
    j_loc: int
    mu_v: int
    mu_s: int
    x_shards: np.ndarray       # uint32[mu_s, j_loc] (FASST-sorted chunks)
    owned_ids: np.ndarray      # int32[mu_v, n_loc] original vertex id per row
    # propagate buckets: write row = src (local id), read row = dst (block id)
    p_h: Tuple[torch.Tensor, ...]  # kk -> [mu_v, mu_s, B_kk] edge hash (uint32 bits)
    p_w: Tuple[torch.Tensor, ...]  # int32 local write row
    p_r: Tuple[torch.Tensor, ...]  # int32 row within the read block
    p_t: Tuple[torch.Tensor, ...]  # threshold / interval width (uint32 bits)
    p_l: Tuple[torch.Tensor, ...]  # interval low endpoint (uint32 bits)
    # cascade buckets: write row = dst (local id), read row = src (block id)
    c_h: Tuple[torch.Tensor, ...]
    c_w: Tuple[torch.Tensor, ...]
    c_r: Tuple[torch.Tensor, ...]
    c_t: Tuple[torch.Tensor, ...]
    c_l: Tuple[torch.Tensor, ...]
    edge_counts: np.ndarray    # int64[mu_v, mu_s] real edges per shard
    p_counts: np.ndarray       # int64[mu_v, mu_s, mu_v] real edges per bucket
    c_counts: np.ndarray
    comm_bytes_per_sweep: int  # ring traffic per device per sweep
    plan: Optional[PartitionPlan] = None
    pad_mode: str = "step"

    def stats(self):
        """Measured cost-model stats (``partition.cost``)."""
        from repro_torch.partition.cost import measure_partition

        return measure_partition(self)


def _bucketize_steps(w_own, k, fields, mu_v: int, widths: np.ndarray):
    """Scatter per-edge ``fields`` (h, w, r, t, l; edges in ascending id)
    into per-step padded buckets: for each step kk, five ``(mu_v,
    widths[kk])`` tensors. A stable sort by (kk, write shard) keeps the
    ascending edge id within each bucket."""
    key = k * mu_v + w_own
    order = torch.sort(key, stable=True).indices
    sorted_fields = [f[order] for f in fields]
    bounds = [0] + torch.cumsum(torch.bincount(key, minlength=mu_v * mu_v), 0).tolist()
    steps = []
    for kk in range(mu_v):
        outs = [torch.zeros((mu_v, int(widths[kk])), dtype=torch.int32, device=key.device)
                for _ in fields]
        for v in range(mu_v):
            lo, hi = bounds[kk * mu_v + v], bounds[kk * mu_v + v + 1]
            for out, f in zip(outs, sorted_fields):
                out[v, : hi - lo] = f[lo:hi]
        steps.append(outs)
    return steps


#: the padded bucket widths' multiple
EDGE_BLOCK = 256


def _round_up(v: np.ndarray, block: int) -> np.ndarray:
    return v + (-v) % block


def _bucket_widths(counts_p: np.ndarray, counts_c: np.ndarray, pad_mode: str,
                   edge_block: int) -> tuple:
    """Each ring step's padded bucket width, propagate and cascade, from
    every shard's bucket counts (``(mu_v, mu_s, mu_v)``), so that every
    shard pads alike."""
    mu_v = counts_p.shape[0]
    if pad_mode == "global":
        b_max = int(max(counts_p.max(initial=0), counts_c.max(initial=0), 1))
        b_max += (-b_max) % edge_block
        widths = np.full(mu_v, b_max, dtype=np.int64)
        return widths, widths
    return (_round_up(counts_p.max(axis=(0, 1)), edge_block),
            _round_up(counts_c.max(axis=(0, 1)), edge_block))


@trace.traced("partition.build_buckets", phase="plan", sync=True)
def build_partition_2d(g: Graph, x: np.ndarray, mu_v: int, mu_s: int, *,
                       seed: int = 0, method: str = "fasst", edge_block: int = EDGE_BLOCK,
                       model: str = "wc", plan: Optional[PartitionPlan] = None,
                       pad_mode: str = "step", sampled: Optional[SampledEdges] = None,
                       device=None) -> Partition2D:
    """FASST sample split times planned vertex split, fully bucketed, on the
    device of ``sampled`` (made on ``device`` when not given). ``plan=None``
    builds the ``block`` plan. Runs in a ``partition.build_buckets`` span
    that synchronizes the buckets."""
    if pad_mode not in ("global", "step"):
        raise ValueError(f"pad_mode must be 'global' or 'step', got {pad_mode!r}")
    r = x.shape[0]
    if r % mu_s:
        raise ValueError(f"{r} samples do not split into {mu_s} sim shards")
    if sampled is None:
        sampled = sample_edge_sets(g, x, mu_s, seed=seed, model=model, method=method,
                                   device=device)
    dev = sampled.device
    j_loc = r // mu_s
    if plan is None:
        plan = plan_partition(g, mu_v, mu_s=mu_s, strategy="block", seed=seed,
                              model=model)
    plan.validate(g)
    if plan.mu_v != mu_v:
        raise ValueError(f"plan built for mu_v={plan.mu_v}, asked for {mu_v}")
    n_loc = plan.n_loc
    perm = torch.from_numpy(plan.perm.astype(np.int64)).to(dev)
    rows = perm[torch.from_numpy(g.src.astype(np.int64)).to(dev)]
    cols = perm[torch.from_numpy(g.dst.astype(np.int64)).to(dev)]
    own_src, own_dst = rows // n_loc, cols // n_loc
    src_loc, dst_loc = (rows % n_loc).to(torch.int32), (cols % n_loc).to(torch.int32)
    # bucket counts first, so that every shard pads alike
    counts_p = np.zeros((mu_v, mu_s, mu_v), dtype=np.int64)
    counts_c = np.zeros((mu_v, mu_s, mu_v), dtype=np.int64)
    per_shard = []
    for s, ids in enumerate(sampled.masks):
        ws, wd = own_src[ids], own_dst[ids]
        kp, kc = (wd - ws) % mu_v, (ws - wd) % mu_v
        counts_p[:, s, :] = torch.bincount(ws * mu_v + kp, minlength=mu_v * mu_v
                                           ).reshape(mu_v, mu_v).cpu().numpy()
        counts_c[:, s, :] = torch.bincount(wd * mu_v + kc, minlength=mu_v * mu_v
                                           ).reshape(mu_v, mu_v).cpu().numpy()
        per_shard.append((ids, ws, wd, kp, kc))
    counts = counts_p.sum(axis=2)
    widths_p, widths_c = _bucket_widths(counts_p, counts_c, pad_mode, edge_block)

    p_parts, c_parts = [], []
    for ids, ws, wd, kp, kc in per_shard:
        e_h, e_t, e_l = sampled.h[ids], sampled.thr[ids], sampled.lo[ids]
        s_loc, d_loc = src_loc[ids], dst_loc[ids]
        p_parts.append(_bucketize_steps(ws, kp, (e_h, s_loc, d_loc, e_t, e_l), mu_v,
                                        widths_p))
        c_parts.append(_bucketize_steps(wd, kc, (e_h, d_loc, s_loc, e_t, e_l), mu_v,
                                        widths_c))

    def stack(parts, i):
        # parts[s][kk][i] is (mu_v, B_kk); stack sim shards -> (mu_v, mu_s, B_kk)
        return tuple(torch.stack([parts[s][kk][i] for s in range(mu_s)], dim=1)
                     for kk in range(mu_v))

    return Partition2D(
        n=g.n, n_pad=plan.n_pad, n_loc=n_loc, j_loc=j_loc, mu_v=mu_v, mu_s=mu_s,
        x_shards=sampled.x_shards, owned_ids=plan.owned_ids(),
        p_h=stack(p_parts, 0), p_w=stack(p_parts, 1), p_r=stack(p_parts, 2),
        p_t=stack(p_parts, 3), p_l=stack(p_parts, 4),
        c_h=stack(c_parts, 0), c_w=stack(c_parts, 1), c_r=stack(c_parts, 2),
        c_t=stack(c_parts, 3), c_l=stack(c_parts, 4),
        edge_counts=counts, p_counts=counts_p, c_counts=counts_c,
        comm_bytes_per_sweep=(mu_v - 1) * n_loc * j_loc, plan=plan, pad_mode=pad_mode)
