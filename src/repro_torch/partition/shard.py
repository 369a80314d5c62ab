"""One shard's 2-D partition, prepared without the others: a mesh rank's prep.

``build_shard_2d`` gives a rank of the mesh what it takes from the whole
build (``builder.build_partition_2d``, cut by ``partition.serial._shard_rows``):
shard ``(v, s)``'s propagate and cascade work lists, byte-equal, and the
whole partition's counts, widths, plan and stats, its bucket tensors
shape-only (``meta``), as in the reference, whose controller builds the
partition once and places each device's ``(v, s)`` slice.

The edges are walked in chunks of ``SHARD_CHUNK``: each chunk's operands go
to the device, where ``fused_sample`` (through ``core.fasst.sampled_by_any``)
tells which sim shards sample each edge. The device holds one chunk and
this shard's own edges, never a graph-wide edge tensor or another shard's
bucket. Without a plan, a first pass reads each edge's multiplicity (the
sim shards that sample it) to the host for the planner. The last pass
counts every (write shard, sim shard, ring step) bucket, from which the
shared widths follow, and keeps the edges of sim shard s that vertex shard
v writes; the chunks go in ascending edge id, so a bucket's edges keep the
order the whole build's stable sort gives them. The work is deterministic:
every rank makes the same counts and plan, and nothing is exchanged.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.fasst import _bits, partition_samples, sampled_by_any
from repro_torch.device import resolve_device, synchronize
from repro_torch.diffusion import resolve as resolve_model
from repro_torch.graphs.structs import Graph
from repro_torch.kernels.edges import group_rows, with_work
from repro_torch.obs import trace
from repro_torch.partition.builder import EDGE_BLOCK, Partition2D, _bucket_widths
from repro_torch.partition.plan import PartitionPlan, _plan_from_multiplicity

#: edges a pass uploads and samples at once: 256 MiB of ``fused_sample`` mask
#: at 512 samples
SHARD_CHUNK = 1 << 19


def _chunks(g: Graph, ep, xs: list, variant: int, dev):
    """Per chunk of ``SHARD_CHUNK`` edges: ``(a, b, (h, lo, thr), live)``, the
    chunk's operands on ``dev`` and, per sim shard, ``bool[b - a]``: one of
    its samples makes the edge live."""
    for a in range(0, g.m, SHARD_CHUNK):
        b = min(a + SHARD_CHUNK, g.m)
        operands = tuple(_bits(f[a:b], dev) for f in (ep.h, ep.lo, ep.thr))
        yield a, b, operands, [sampled_by_any(*operands, xt, variant=variant) for xt in xs]


def _multiplicity(g: Graph, ep, xs: list, variant: int, dev) -> np.ndarray:
    """int64[m_real]: how many sim shards sample each real edge."""
    c_e = np.zeros(g.m_real, dtype=np.int64)
    for a, b, _, live in _chunks(g, ep, xs, variant, dev):
        hi = min(b, g.m_real)
        if hi > a:
            c_e[a:hi] = torch.stack(live).sum(0)[: hi - a].cpu().numpy()
    return c_e


def _count_and_keep(g: Graph, ep, xs: list, variant: int, plan: PartitionPlan, v: int,
                    s: int, dev) -> tuple:
    """Every bucket's count, ``(counts_p, counts_c)`` int64 ``(mu_v, mu_s,
    mu_v)``, and shard ``(v, s)``'s edges per side: chunk lists of (ring
    step, write row, read row, h, lo, thr), in ascending edge id."""
    mu_v, mu_s, n_loc = plan.mu_v, len(xs), plan.n_loc
    perm = torch.from_numpy(plan.perm.astype(np.int64)).to(dev)
    cnt_p = torch.zeros((mu_s, mu_v * mu_v), dtype=torch.int64, device=dev)
    cnt_c = torch.zeros_like(cnt_p)
    own_p, own_c = [], []
    for a, b, (h, lo, thr), live in _chunks(g, ep, xs, variant, dev):
        src, dst = (torch.from_numpy(np.require(e[a:b], None, ["C", "W"])).to(dev)
                    for e in (g.src, g.dst))
        rows, cols = perm.index_select(0, src), perm.index_select(0, dst)
        ws, wd = rows // n_loc, cols // n_loc
        kp, kc = (wd - ws) % mu_v, (ws - wd) % mu_v
        key_p, key_c = ws * mu_v + kp, wd * mu_v + kc
        for t, lv in enumerate(live):   # an edge its samples miss counts in the last bin
            cnt_p[t] += torch.bincount(torch.where(lv, key_p, mu_v * mu_v),
                                       minlength=mu_v * mu_v + 1)[:-1]
            cnt_c[t] += torch.bincount(torch.where(lv, key_c, mu_v * mu_v),
                                       minlength=mu_v * mu_v + 1)[:-1]
        src_loc, dst_loc = (rows % n_loc).to(torch.int32), (cols % n_loc).to(torch.int32)
        for sel, k, w, r, out in ((live[s] & (ws == v), kp, src_loc, dst_loc, own_p),
                                  (live[s] & (wd == v), kc, dst_loc, src_loc, own_c)):
            idx = torch.nonzero(sel).flatten()
            out.append(tuple(f.index_select(0, idx) for f in (k.to(torch.int32), w, r, h, lo,
                                                               thr)))

    def host(cnt):   # (mu_s, mu_v * mu_v) -> (mu_v, mu_s, mu_v)
        return np.ascontiguousarray(cnt.reshape(mu_s, mu_v, mu_v).permute(1, 0, 2).cpu().numpy())

    return host(cnt_p), host(cnt_c), own_p, own_c


def _own_rows(chunks: list, mu_v: int, n_loc: int) -> list:
    """``rows[kk]``: the kept edges of ring step kk grouped by write row,
    with their work list (``_shard_rows``'s). Empties ``chunks`` once they
    are joined, so that the device holds them once."""
    k, w, r, h, lo, thr = [torch.cat([c[i] for c in chunks]) for i in range(6)]
    chunks.clear()
    out = []
    for kk in range(mu_v):
        sel = k == kk
        out.append(with_work(group_rows(w[sel], r[sel], h[sel], lo[sel], thr[sel], n_loc)))
    return out


def _shape_only(widths: np.ndarray, mu_v: int, mu_s: int) -> tuple:
    """Per ring step, a ``meta`` int32 ``(mu_v, mu_s, width)`` bucket tensor."""
    return tuple(torch.empty((mu_v, mu_s, int(wd)), dtype=torch.int32, device="meta")
                 for wd in widths)


def build_shard_2d(g: Graph, x: np.ndarray, mu_v: int, mu_s: int, v: int, s: int, *,
                   seed: int = 0, method: str = "fasst", model: str = "wc",
                   strategy: str = "block", plan: Optional[PartitionPlan] = None,
                   pad_mode: str = "step", device=None,
                   stats: Optional[dict] = None) -> tuple:
    """Shard ``(v, s)``'s partition on ``device`` (CUDA unless ``"cpu"``),
    with no other shard's buckets: ``(Partition2D, (p_rows, c_rows))``,
    ``p_rows[kk]`` and ``c_rows[kk]`` the shard's work lists of ring step
    kk. The partition's bucket tensors are ``meta`` tensors of the whole
    build's shapes; everything else equals the whole build's. ``plan=None``
    plans with ``strategy`` from the sample multiplicities, as the serial
    ring's ``_prepare`` does; a plan given is validated. ``stats`` gets the
    host seconds ``sample_s`` (the edge operands and, without a plan, the
    multiplicity pass), ``plan_s`` and ``buckets_s`` (the counting pass and
    the work lists), each ending in a device sync. Runs in a
    ``partition.build_shard`` span."""
    if pad_mode not in ("global", "step"):
        raise ValueError(f"pad_mode must be 'global' or 'step', got {pad_mode!r}")
    x = np.asarray(x, dtype=np.uint32)
    r = x.shape[0]
    if r % mu_s:
        raise ValueError(f"{r} samples do not split into {mu_s} sim shards")
    dev = resolve_device(device)
    stats = {} if stats is None else stats
    j_loc = r // mu_s
    with trace.span("partition.build_shard", phase="plan", v=v, s=s, mu_v=mu_v, mu_s=mu_s):
        t0 = time.perf_counter()
        mdl = resolve_model(model)
        ep = mdl.edge_params(g, seed=seed)
        x_shards, _ = partition_samples(x, mu_s, method=method)
        xs = [_bits(x_shards[t], dev) for t in range(mu_s)]
        c_e = None if plan is not None else _multiplicity(g, ep, xs, mdl.variant, dev)
        synchronize(dev)
        t1 = time.perf_counter()
        if plan is None:
            plan = _plan_from_multiplicity(g, mu_v, c_e, mu_s=mu_s, strategy=strategy,
                                           j_loc=j_loc, seed=seed)
        plan.validate(g)
        if plan.mu_v != mu_v:
            raise ValueError(f"plan built for mu_v={plan.mu_v}, asked for {mu_v}")
        t2 = time.perf_counter()
        counts_p, counts_c, own_p, own_c = _count_and_keep(g, ep, xs, mdl.variant, plan, v,
                                                           s, dev)
        rows = (_own_rows(own_p, mu_v, plan.n_loc), _own_rows(own_c, mu_v, plan.n_loc))
        synchronize(dev)
        stats.update(sample_s=t1 - t0, plan_s=t2 - t1, buckets_s=time.perf_counter() - t2)
    widths_p, widths_c = _bucket_widths(counts_p, counts_c, pad_mode, EDGE_BLOCK)
    p, c = _shape_only(widths_p, mu_v, mu_s), _shape_only(widths_c, mu_v, mu_s)
    part = Partition2D(
        n=g.n, n_pad=plan.n_pad, n_loc=plan.n_loc, j_loc=j_loc, mu_v=mu_v, mu_s=mu_s,
        x_shards=x_shards, owned_ids=plan.owned_ids(),
        p_h=p, p_w=p, p_r=p, p_t=p, p_l=p, c_h=c, c_w=c, c_r=c, c_t=c, c_l=c,
        edge_counts=counts_p.sum(axis=2), p_counts=counts_p, c_counts=counts_c,
        comm_bytes_per_sweep=(mu_v - 1) * plan.n_loc * j_loc, plan=plan, pad_mode=pad_mode)
    return part, rows
