"""FASST, fusing-aware sample-space tasking (paper §4.1).

Counterpart of the reference's ``core/fasst.py`` ``partition_samples`` and
``_sampled_by_any``. Sorting X keeps each sim shard's contiguous chunk of
samples on a small edge subset: that subset is the shard's device-local
graph. ``partition_samples`` is host numpy; ``sampled_by_any`` runs on the
operands' device through ``kernels.ops.fused_sample``, in edge chunks.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sketch import pad_x
from repro_torch.kernels import ops

#: edges per ``fused_sample`` launch: 512 MiB of mask at 512 samples
SAMPLE_CHUNK = 1 << 20


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
