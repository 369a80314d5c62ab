"""Plain reference of DiFuseR's Alg. 4 (influence maximization from FM
sketches), in NumPy and plain PyTorch, for judging the program's seed sets.

It works everything out again from the raw inputs: the edge arrays, their
weights, the diffusion model's name, the register count J, K and the hash
seed. Nothing here comes from the program under test.

* **Graph.** Self loops are dropped and parallel ``(u, v)`` edges merge
  with probability ``1 - prod(1 - w)``.
* **Sampling (paper §2.2).** Register r of edge e is live when a hash of
  the edge (or of its destination) and the random word ``x_r`` pass the
  model's predicate:
  - ``wc`` (thresholds from the weights): ``((x_r ^ h(u, v)) - 0) <
    round(w * 2^32)``;
  - ``lt`` (Kempe, Kleinberg and Tardos's Linear Threshold by live edges):
    each vertex v cuts ``[0, 2^32)`` into consecutive intervals of width
    ``w_uv / max(1, sum of v's in-weights)`` over its in-edges in (v, u)
    order, and ``mix32(x_r ^ h(v))`` picks at most one of them. The
    interval ends are float64 running sums over all edges in (v, u) order,
    rounded to 32 bits.
  The live (edge, register) pairs are listed once, as flat matrix indices,
  and every sweep walks that list: the sampled graphs, materialised.
* **Sketches (§2.3, Alg. 1).** ``M[u, j] = clz(register_hash(u, j))``, int8;
  -1 marks a register VISITED by the committed seeds.
* **Build (Alg. 2).** Jacobi sweeps ``M[u] = max(M[u], M[v])`` over live
  ``(u, v)``, VISITED kept, until a sweep changes nothing or 64 have run;
  the sweep that changes nothing counts.
* **Rounds (Alg. 4 lines 7-23).** Select the vertex of the largest
  estimate (the harmonic estimator ``1.4427 * c / sum(2^-M)`` over the c
  registers that are not VISITED, times ``c / J``; the first of equals),
  mark its row VISITED, spread the cascade with Jacobi sweeps (a live
  ``(u, v)`` with ``M[u]`` VISITED marks ``M[v]``, same stopping rule),
  score the VISITED count over J, and rebuild when the score grew by more
  than 1 % of itself: every register that is not VISITED is filled afresh
  and the build's sweeps run again.

The score and estimate arithmetic runs in ``dtype`` (float32, in the
program's order of operations; the sum of ``2^-M`` is formed exactly in
int64 and rounded once). Where the registers are split into ``sim_shards``
contiguous blocks (the 2-D schedule's simulation shards, paper §4), each
block's sum is formed exactly and rounded once, and the blocks' float32
sums are added in block order, as the schedule's sum over simulation
shards does: two roundings, which can move the sum by one unit in the last
place against the whole row's. ``dtype=torch.bfloat16`` is the control:
the same algorithm one precision lower, which the comparison has to reject.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

VISITED = -1
MASK32 = 0xFFFFFFFF
_M1, _M2, _GOLD = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9
_C_HARMONIC = 1.4426950408889634
_TWO32 = 4294967296.0
#: (edge, register) pairs a chunk of the live-pair search handles at once
_PAIR_CHUNK = 1 << 26
#: registers a chunk of the row-wise passes handles at once
_CELL_CHUNK = 1 << 26


@dataclasses.dataclass
class Answer:
    """What a run of Alg. 4 answers: the seeds in the order chosen, each
    round's estimated gain and score, whether it rebuilt, and the sweeps of
    the build, of the cascades and of the rebuilds."""

    seeds: np.ndarray
    gains: np.ndarray
    scores: np.ndarray
    rebuilds: np.ndarray
    build_sweeps: int
    cascade_sweeps: int
    rebuild_sweeps: int


# -- hashing, on uint32 numpy arrays (host) and int64 tensors holding uint32 ---------

def _np_mix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(_M1)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(_M2)
    return x ^ (x >> np.uint32(16))


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * _M1) & MASK32
    x = x ^ (x >> 13)
    x = (x * _M2) & MASK32
    return x ^ (x >> 16)


def edge_hash(src: np.ndarray, dst: np.ndarray, seed: int) -> np.ndarray:
    """h(u, v), order-sensitive (paper eq. 1)."""
    u, v = src.astype(np.uint32), dst.astype(np.uint32)
    h = _np_mix32(u * np.uint32(_GOLD) + np.uint32(seed))
    return _np_mix32(h ^ (v * np.uint32(_M1) + np.uint32(0x27D4EB2F)))


def vertex_hash(v: np.ndarray, seed: int) -> np.ndarray:
    """h(v) of the Linear Threshold sampler."""
    v = v.astype(np.uint32)
    return _np_mix32(_np_mix32(v * np.uint32(_GOLD) + np.uint32(seed ^ 0x165667B1))
                     ^ np.uint32(0x27D4EB2F))


def random_words(num_registers: int, seed: int) -> np.ndarray:
    """x: J uniform 32-bit words from the seed, sorted (FASST order, §4.1)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=num_registers, dtype=np.uint64).astype(np.uint32)
    return np.sort(x)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    n = torch.full_like(x, 32)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        n = torch.where(big, n - shift, n)
        x = torch.where(big, x >> shift, x)
    return n - x


def fill(n: int, num_registers: int, seed: int, device) -> torch.Tensor:
    """Alg. 1: ``int8[n, J]``, ``clz(mix32(mix32(u * GOLD + (seed ^ c)) ^
    (j * M2)))``."""
    out = torch.empty((n, num_registers), dtype=torch.int8, device=device)
    j = (torch.arange(num_registers, dtype=torch.int64, device=device) * _M2) & MASK32
    rows = max(1, _CELL_CHUNK // num_registers)
    salt = (seed ^ 0x5BD1E995) & MASK32
    for r0 in range(0, n, rows):
        u = torch.arange(r0, min(r0 + rows, n), dtype=torch.int64, device=device)
        a = _mix32((((u * _GOLD) & MASK32) + salt) & MASK32)
        out[r0:r0 + rows] = _clz32(_mix32(a[:, None] ^ j[None, :])).to(torch.int8)
    return out


# -- the graph and the model's operands (host) -------------------------------------

def dedup(n: int, src, dst, weight) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Self loops dropped, parallel edges merged (``1 - prod(1 - w)``),
    sorted by (u, v)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    w = np.asarray(weight, dtype=np.float64)
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    key = src * n + dst
    uniq, inverse = np.unique(key, return_inverse=True)
    if uniq.size == key.size:
        order = np.argsort(key)
        return src[order], dst[order], w[order].astype(np.float32)
    log_keep = np.zeros(uniq.size)
    np.add.at(log_keep, inverse, np.log1p(-np.clip(w, 0.0, 0.999999)))
    return uniq // n, uniq % n, (1.0 - np.exp(log_keep)).astype(np.float32)


def _thresholds(w: np.ndarray) -> np.ndarray:
    return np.minimum(np.round(w.astype(np.float64) * _TWO32), float(MASK32)).astype(np.uint32)


def lt_intervals(n: int, dst: np.ndarray, weight: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Linear Threshold intervals (lo, width) as uint32, for edges
    sorted by (v, u)."""
    w = np.clip(weight.astype(np.float32).astype(np.float64), 0.0, 1.0)
    total_in = np.zeros(n, dtype=np.float64)
    np.add.at(total_in, dst, w)
    b = w / np.maximum(total_in, 1.0)[dst]
    hi = np.cumsum(b)
    lo = hi - b
    starts = np.concatenate([[True], dst[1:] != dst[:-1]])
    base = np.maximum.accumulate(np.where(starts, lo, -np.inf))
    lo_u = np.minimum(np.round((lo - base) * _TWO32), _TWO32).astype(np.uint64)
    hi_u = np.minimum(np.round((hi - base) * _TWO32), _TWO32).astype(np.uint64)
    width = np.minimum(hi_u - lo_u, np.uint64(MASK32)).astype(np.uint32)
    return np.minimum(lo_u, np.uint64(MASK32)).astype(np.uint32), width


def live_pairs(n: int, src, dst, weight, *, model: str, x: np.ndarray, seed: int,
               device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Every live (edge, register) pair as ``(u * J + j, v * J + j)`` flat
    indices of the matrix, in chunks."""
    src, dst, weight = dedup(n, src, dst, weight)
    num_regs = x.shape[0]
    if model == "wc":
        h = edge_hash(src, dst, seed)
        lo = np.zeros(src.shape[0], dtype=np.uint32)
        width = _thresholds(weight)
    elif model == "lt":
        order = np.lexsort((src, dst))
        src, dst, weight = src[order], dst[order], weight[order]
        lo, width = lt_intervals(n, dst, weight)
        h = vertex_hash(dst, seed)
    else:
        raise ValueError(f"the reference knows the models wc and lt, not {model!r}")
    as_t = lambda a: torch.from_numpy(a.astype(np.int64)).to(device)  # noqa: E731
    xs = as_t(x)[None, :]
    src_t, dst_t, h_t, lo_t, w_t = map(as_t, (src, dst, h, lo, width))
    index_dtype = torch.int32 if n * num_regs < 2 ** 31 else torch.int64
    step = max(1, _PAIR_CHUNK // num_regs)
    pairs = []
    for e0 in range(0, src.shape[0], step):
        sl = slice(e0, e0 + step)
        mixed = xs ^ h_t[sl, None]
        if model == "lt":
            mixed = _mix32(mixed)
        live = ((mixed - lo_t[sl, None]) & MASK32) < w_t[sl, None]
        e, j = live.nonzero(as_tuple=True)
        pairs.append(((src_t[sl][e] * num_regs + j).to(index_dtype),
                      (dst_t[sl][e] * num_regs + j).to(index_dtype)))
    return pairs


# -- the sweeps ---------------------------------------------------------------------

def propagate_sweep(m: torch.Tensor, pairs) -> Tuple[torch.Tensor, bool]:
    """Alg. 2, Jacobi: each live (u, v) raises M[u] to M[v]; VISITED stays."""
    flat = m.view(-1)
    acc = flat.to(torch.int32)
    for u_j, v_j in pairs:
        acc.scatter_reduce_(0, u_j.long(), flat[v_j].to(torch.int32), "amax")
    out = torch.where(m == VISITED, m, acc.view(m.shape).to(torch.int8))
    return out, bool((out != m).any())


def cascade_sweep(m: torch.Tensor, pairs) -> Tuple[torch.Tensor, bool]:
    """Alg. 3, Jacobi: each live (u, v) with M[u] VISITED marks M[v]."""
    flat = m.view(-1)
    out = m.clone()
    oflat = out.view(-1)
    for u_j, v_j in pairs:
        oflat[v_j[flat[u_j] == VISITED].long()] = VISITED
    return out, bool((out != m).any())


def fixpoint(sweep, m: torch.Tensor, pairs, max_iters: int) -> Tuple[torch.Tensor, int]:
    iters, changed = 0, True
    while changed and iters < max_iters:
        m, changed = sweep(m, pairs)
        iters += 1
    return m, iters


# -- selection and score ------------------------------------------------------------

def row_statistics(m: torch.Tensor, sim_shards: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row: the sum of 2^-M over the registers that are not VISITED, and
    their count. The sum is exact in int64 over each of ``sim_shards``
    contiguous blocks of registers, rounded once to float32, and the
    blocks' sums are added in float32 in block order."""
    num_registers = m.shape[1]
    if num_registers % sim_shards:
        raise ValueError(f"{num_registers} registers do not split into {sim_shards} shards")
    width = num_registers // sim_shards
    stat = torch.zeros(m.shape[0], dtype=torch.float32, device=m.device)
    count = torch.empty(m.shape[0], dtype=torch.int64, device=m.device)
    rows = max(1, _CELL_CHUNK // num_registers)
    for r0 in range(0, m.shape[0], rows):
        blk = m[r0:r0 + rows].to(torch.int64)
        valid = blk != VISITED
        pow2 = torch.where(valid, torch.ones_like(blk) << (32 - blk), 0)
        for s in range(sim_shards):
            part = pow2[:, s * width:(s + 1) * width].sum(1)
            stat[r0:r0 + rows] += part.to(torch.float32) * 2.0 ** -32
        count[r0:r0 + rows] = valid.sum(1)
    return stat, count


def select(m: torch.Tensor, num_registers: int, dtype, sim_shards: int = 1) -> Tuple[int, float]:
    """The first vertex of the largest estimate, and the estimate."""
    stat, count = (t.cpu() for t in row_statistics(m, sim_shards))
    stat, c = stat.to(dtype), count.to(dtype)
    est = torch.tensor(_C_HARMONIC, dtype=dtype) * c / torch.clamp_min(
        stat, torch.tensor(1e-30, dtype=dtype))
    est = est * (c / torch.tensor(float(num_registers), dtype=dtype))
    est = torch.where(count > 0, est, torch.zeros((), dtype=dtype))
    s = int(torch.argmax(est))
    return s, float(est[s])


def find_seeds(n: int, src, dst, weight, *, model: str, num_registers: int, k: int,
               seed: int, rebuild_threshold: float = 0.01, max_iters: int = 64,
               device="cpu", dtype=torch.float32, sim_shards: int = 1) -> Answer:
    """Alg. 4 from the raw edges, on ``device``; the selection's sums over
    ``sim_shards`` blocks of registers (``row_statistics``)."""
    x = random_words(num_registers, seed)
    pairs = live_pairs(n, src, dst, weight, model=model, x=x, seed=seed, device=device)
    fresh = fill(n, num_registers, seed, device)
    m, build_sweeps = fixpoint(propagate_sweep, fresh.clone(), pairs, max_iters)
    one = lambda v: torch.tensor(v, dtype=dtype)  # noqa: E731
    regs, threshold, floor = one(float(num_registers)), one(rebuild_threshold), one(1e-9)
    old = one(0.0)
    seeds, gains, scores, rebuilds = [], [], [], []
    cascade_sweeps = rebuild_sweeps = 0
    for _ in range(k):
        s, gain = select(m, num_registers, dtype, sim_shards)
        m = m.clone()
        m[s] = VISITED
        m, it = fixpoint(cascade_sweep, m, pairs, max_iters)
        cascade_sweeps += it
        score = one(float(torch.count_nonzero(m == VISITED))) / regs
        rebuild = bool((score - old) / torch.maximum(score, floor) > threshold)
        if rebuild:
            m = torch.where(m == VISITED, m, fresh)
            m, it = fixpoint(propagate_sweep, m, pairs, max_iters)
            rebuild_sweeps += it
            old = score
        seeds.append(s)
        gains.append(gain)
        scores.append(float(score))
        rebuilds.append(rebuild)
    return Answer(seeds=np.asarray(seeds, np.int32), gains=np.asarray(gains, np.float32),
                  scores=np.asarray(scores, np.float32), rebuilds=np.asarray(rebuilds, bool),
                  build_sweeps=build_sweeps, cascade_sweeps=cascade_sweeps,
                  rebuild_sweeps=rebuild_sweeps)
