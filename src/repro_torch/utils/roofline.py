"""The H100's published roofs, the dry run's three-term roofline, and the
bandwidth attribution of a span.

Counterpart of the reference's ``utils/roofline.py``. The roofs are the data
sheet's for the card the port targets, an NVIDIA H100 SXM5 80GB, never the
reference's TPU constants: device memory 3.35 TB/s; INT32 132 SMs x 64 lanes
x 1.98 GHz, about 16.7 T operations per second; NVLink 4 per direction.
"""
from __future__ import annotations

import dataclasses

#: the card the roofs below belong to
CARD = "NVIDIA H100 SXM5 80GB"
HBM_BW = 3.35e12                  # B/s, device memory
INT32_OPS = 132 * 64 * 1.98e9     # INT32 operations per second (about 16.7e12)
# B/s of one card's NVLink 4 in one direction: the data sheet gives 900 GB/s
# for both directions together, so a card sends 450 GB/s (and receives as much)
LINK_BW = 450e9


@dataclasses.dataclass
class Roofline:
    """Compute, memory and collective times of one device's share of a dry-run
    record (``launch.dryrun``), the bottleneck, and the useful-work ratio.

    The mesh program does no floating-point products: its ``flops`` count
    integer operations (the kernels' from ``kernels.cost``, one per result
    element of every other op), so ``t_compute`` divides by
    :data:`INT32_OPS`, ``t_memory`` the bytes by :data:`HBM_BW` and
    ``t_collective`` the wire bytes by :data:`LINK_BW`."""

    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops_total: float          # 6·N·D (train) or 2·N·D (inference)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / INT32_OPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The share of the card's peak reached at the bound, counting only
        useful (model) operations: ``(model_flops / chips / t_bound) /
        INT32_OPS``."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops_total / self.chips / self.t_bound) / INT32_OPS

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops_total": self.model_flops_total,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def annotate_bandwidth(sp, nbytes: int, seconds: float) -> float:
    """Attach the achieved GB/s and its fraction of :data:`HBM_BW` to a trace
    span. ``sp`` may be the null span (tracing off): ``annotate`` is then a
    no-op and only the returned GB/s means anything. Returns 0.0 for a
    degenerate timing instead of raising."""
    if seconds <= 0 or nbytes <= 0:
        return 0.0
    gbps = nbytes / seconds / 1e9
    sp.annotate(achieved_gbps=round(gbps, 3), frac_of_roof=round(gbps * 1e9 / HBM_BW, 6))
    return gbps


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS of a cell as the reference defines it: 6·N_active·D for
    training, 2·N_active·D for inference (D: the tokens of the step). It
    reads ``cfg.active_param_count()`` and ``shape.kind``, ``global_batch``
    and ``seq_len``; the IM cells run no model and record no such figure."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
