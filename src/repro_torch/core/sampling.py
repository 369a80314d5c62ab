"""Hash-based fused sampling (paper §2.2).

An edge e belongs to sample r iff ``((X_r ^ h_e) - lo_e) mod 2^32 < thr_e``:
one XOR, one subtract and one unsigned compare per (edge, sample), with no
stored samples and no random state.

Two halves:

* numpy host functions on ``uint32`` arrays (``mix32``, ``edge_hash``,
  ``vertex_hash``, ``register_hash``, ``weight_to_threshold``,
  ``make_x_vector``, the two predicates ``fused_predicate`` and
  ``remix_interval_predicate``, ``sample_mask`` and ``clz32``), copied from
  the reference package's ``core/sampling.py`` so that both packages hash
  and sample identically;
* torch versions of ``mix32``, ``register_hash``, clz and the two
  predicates (``t_*``). PyTorch's ``uint32`` tensors lack ``>>``, ``-`` and ``<`` on
  the CPU, so these compute on ``int64`` tensors that hold values in
  [0, 2^32): every product is masked to 32 bits right after the multiply
  (its low 32 bits are right even where the int64 product wraps), every
  subtraction right after the subtract. The CUDA kernels use ``uint32_t``.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

#: what the predicates take: numpy arrays here, torch tensors in the ``t_*``
Array = Union[np.ndarray, torch.Tensor]

_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B9
MASK32 = 0xFFFFFFFF
UINT32_MAX = np.uint64(0xFFFFFFFF)

# the two predicate forms, as the CUDA kernels number them
INTERVAL = 0  # ((x ^ h) - lo) < thr            -- wc, ic, dic
REMIX = 1     # (mix32(x ^ h) - lo) < thr       -- lt


# ---------------------------------------------------------------- numpy ----

def mix32(x: np.ndarray) -> np.ndarray:
    """Murmur3 fmix32 finalizer on uint32."""
    x = x.astype(np.uint32)
    x = x ^ (x >> 16)
    x = x * np.uint32(_M1)
    x = x ^ (x >> 13)
    x = x * np.uint32(_M2)
    x = x ^ (x >> 16)
    return x


def edge_hash(src: np.ndarray, dst: np.ndarray, seed: int = 0) -> np.ndarray:
    """h(u, v): order-sensitive 32-bit edge hash (paper eq. (1))."""
    u = src.astype(np.uint32)
    v = dst.astype(np.uint32)
    h = mix32(u * np.uint32(_GOLD) + np.uint32(seed))
    return mix32(h ^ (v * np.uint32(_M1) + np.uint32(0x27D4EB2F)))


def register_hash(vertex: np.ndarray, reg: np.ndarray, seed: int = 0) -> np.ndarray:
    """h_j(u): per-register item hash of the FM sketches (paper eq. (3))."""
    u = vertex.astype(np.uint32)
    j = reg.astype(np.uint32)
    return mix32(mix32(u * np.uint32(_GOLD) + np.uint32(seed ^ 0x5BD1E995))
                 ^ (j * np.uint32(_M2)))


def vertex_hash(vertex: np.ndarray, seed: int = 0) -> np.ndarray:
    """h(v): the per-destination hash of the LT live-edge sampler."""
    v = vertex.astype(np.uint32)
    return mix32(mix32(v * np.uint32(_GOLD) + np.uint32(seed ^ 0x165667B1))
                 ^ np.uint32(0x27D4EB2F))


def weight_to_threshold(w: np.ndarray) -> np.ndarray:
    """Map probability w in [0, 1] to the uint32 threshold round(w * 2^32),
    clamped to 2^32 - 1."""
    thr = np.minimum(np.round(np.float64(w) * 4294967296.0), np.float64(UINT32_MAX))
    return thr.astype(np.uint32)


def make_x_vector(num_samples: int, seed: int = 0) -> np.ndarray:
    """The random vector X = {X_1..X_R} (uint32)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=num_samples, dtype=np.uint64).astype(np.uint32)


def fused_predicate(h: np.ndarray, lo: np.ndarray, width: np.ndarray,
                    x: np.ndarray) -> np.ndarray:
    """The edge-activation predicate of the threshold models (wc, ic, dic):
    ``((X_r ^ h_e) - lo_e) mod 2^32 < width_e`` on uint32 operands, which
    broadcast. With lo = 0 it is the paper's ``(X ^ h) < w * 2^32``."""
    return ((h ^ x) - lo) < width


def remix_interval_predicate(h: np.ndarray, lo: np.ndarray, width: np.ndarray,
                             x: np.ndarray) -> np.ndarray:
    """The interval predicate of lt, with an avalanche remix of the
    per-(vertex, sample) uniform: ``(mix32(X_r ^ h_v) - lo_e) mod 2^32 <
    width_e``. All in-edges of v share one uniform a sample, so at most one
    fires."""
    return (mix32(h ^ x) - lo) < width


def sample_mask(edge_h: np.ndarray, thr: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``bool[E, R]``: ``mask[e, r] = (X_r ^ h_e) < thr_e``."""
    return (edge_h[:, None] ^ x[None, :]) < thr.astype(np.uint32)[:, None]


def clz32(x: np.ndarray) -> np.ndarray:
    """Count leading zeros of uint32 values (clz(0) = 32), int32."""
    x = x.astype(np.uint32)
    n = np.full(x.shape, 32, dtype=np.int32)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (np.uint32(1) << np.uint32(shift))
        n = np.where(big, n - shift, n)
        x = np.where(big, x >> np.uint32(shift), x)
    return n - x.astype(np.int32)


# ---------------------------------------------------------------- torch ----

def as_u32(t: torch.Tensor) -> torch.Tensor:
    """A uint32 (or int32 bit pattern) tensor as int64 values in [0, 2^32)."""
    if t.dtype == torch.uint32:
        return t.to(torch.int64)
    return t.to(torch.int64) & MASK32


def t_mix32(x: torch.Tensor) -> torch.Tensor:
    """fmix32 on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * _M1) & MASK32
    x = x ^ (x >> 13)
    x = (x * _M2) & MASK32
    return x ^ (x >> 16)


def t_register_hash(u: torch.Tensor, j: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """``register_hash`` on int64 tensors holding uint32 values (broadcasts)."""
    a = (((u * _GOLD) & MASK32) + ((seed ^ 0x5BD1E995) & MASK32)) & MASK32
    return t_mix32(t_mix32(a) ^ ((j * _M2) & MASK32))


def t_fused_predicate(h, lo, thr, x) -> torch.Tensor:
    """``((x ^ h) - lo) mod 2^32 < thr`` on int64 tensors holding uint32."""
    return (((x ^ h) - lo) & MASK32) < thr


def t_remix_interval_predicate(h, lo, thr, x) -> torch.Tensor:
    """``(mix32(x ^ h) - lo) mod 2^32 < thr`` on int64 tensors."""
    return ((t_mix32(x ^ h) - lo) & MASK32) < thr


PREDICATES = {INTERVAL: t_fused_predicate, REMIX: t_remix_interval_predicate}


def t_clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of int64 tensors holding uint32 values
    (clz(0) = 32), by the same five-step binary search as the reference's
    ``clz32``."""
    n = torch.full_like(x, 32)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        n = torch.where(big, n - shift, n)
        x = torch.where(big, x >> shift, x)
    return n - x
