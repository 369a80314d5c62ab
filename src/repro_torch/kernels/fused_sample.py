"""Hash-based fused edge sampling (paper §2.2, eq. (2)): the dense mask
``out[e, r] = predicate(h[e], lo[e], thr[e], x[r])`` as ``uint8[E, R]``.

``fused_sample_cuda`` launches ``csrc/fused_sample.cu``, which replaces the
Pallas kernel ``src/repro/kernels/fused_sample.py`` (``fused_sample_pallas``):
a thread keeps one chunk of 16 samples' x in registers (4 where R is not a
multiple of 16) and walks the edges, one streaming store of the chunk's
bytes an edge. It takes R a multiple of 4; ``core.fasst.sampled_by_any``
pads x to one. ``fused_sample_plain`` is its plain PyTorch version. ``h``,
``lo``, ``thr`` (int32[E]) and ``x`` (int32[R]) hold uint32 bit patterns.
"""
from __future__ import annotations

import torch

from repro_torch.core.sampling import PREDICATES, as_u32
from repro_torch.kernels import build, counters
from repro_torch.kernels.common import PLAIN_STEP, check_x, stream

NAME = "fused_sample"


def _check(h, lo, thr, x) -> None:
    for name, t in (("h", h), ("lo", lo), ("thr", thr)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32[E] tensor (uint32 bits), "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not h.shape == lo.shape == thr.shape:
        raise ValueError(f"h, lo and thr differ in length: {h.shape[0]}, {lo.shape[0]}, "
                         f"{thr.shape[0]}")
    if x.dim() != 1:
        raise ValueError(f"x must be a 1-D tensor, got shape {tuple(x.shape)}")
    check_x(x, x.shape[0])
    if any(t.device != h.device for t in (lo, thr, x)):
        raise ValueError("h, lo, thr and x must share a device")


def fused_sample_cuda(h, lo, thr, x, *, variant: int) -> torch.Tensor:
    _check(h, lo, thr, x)
    if h.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {h.device}")
    num_samples = x.shape[0]
    if num_samples % 4:
        raise ValueError(f"the CUDA kernels take a sample count that is a multiple "
                         f"of 4, got R={num_samples}")
    out = torch.empty((h.shape[0], num_samples), dtype=torch.uint8, device=h.device)
    fn = build.load(NAME)
    build.check(NAME, fn(h.data_ptr(), lo.data_ptr(), thr.data_ptr(), x.data_ptr(),
                         out.data_ptr(), h.shape[0], num_samples, int(variant),
                         stream(h.device)))
    counters.LAUNCHES[NAME] += 1
    return out


def fused_sample_plain(h, lo, thr, x, *, variant: int) -> torch.Tensor:
    _check(h, lo, thr, x)
    counters.PLAIN_CALLS[NAME] += 1
    pred = PREDICATES[int(variant)]
    num_samples = x.shape[0]
    xs = as_u32(x)[None, :]
    out = torch.empty((h.shape[0], num_samples), dtype=torch.uint8, device=h.device)
    step = max(1, PLAIN_STEP // max(num_samples, 1))
    for e0 in range(0, h.shape[0], step):
        sl = slice(e0, e0 + step)
        out[sl] = pred(as_u32(h[sl])[:, None], as_u32(lo[sl])[:, None],
                       as_u32(thr[sl])[:, None], xs).to(torch.uint8)
    return out
