"""Collective traffic of a dry rank, in wire bytes per device.

Counterpart of the reference's ``utils/hlo.py``. The reference parses the
collectives out of the compiled (post-SPMD) HLO text; the port has no HLO,
so there is no parser here: a ``launch.mesh.DryExchange`` records each
collective the rank program calls as a ``CollectiveRecord``, and
``collective_stats`` applies the reference's ring formulas to those records:

    all-reduce          2 * B * (N-1)/N   (reduce-scatter + all-gather)
    all-gather          B_out * (N-1)/N
    collective-permute  B                 (point-to-point)
    scatter, gather     B * (N-1)/N       (under their own names)

B is the result's bytes (the gathered tensor for an all-gather, every chunk
for a scatter or a gather) and N the group's size. The exchange's kinds take
the reference's names: ``ring_shift`` is ``collective-permute``,
``all_gather`` ``all-gather``, ``all_reduce`` and ``all_reduce_max``
``all-reduce``. ``ordered_sum`` (the selection statistics' sum over the sim
shards, added in shard order) is the reference's ``psum``, an
``all-reduce``: an ``all_to_all`` and an ``all_gather`` of ``1/N`` chunks
each, which move the ring all-reduce's ``2 * B * (N-1)/N``, B its padded
sum.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Tuple


class CollectiveRecord(NamedTuple):
    """One collective of a dry rank: the exchange's kind, the payload B in
    bytes, the group size N and the shape this rank sends."""

    kind: str
    payload: int
    group: int
    shape: Tuple[int, ...]


#: the exchange's kinds under the reference's names
KINDS = {"ring_shift": "collective-permute", "all_gather": "all-gather",
         "all_reduce": "all-reduce", "all_reduce_max": "all-reduce",
         "ordered_sum": "all-reduce",
         "scatter": "scatter", "gather": "gather"}


def wire_bytes(kind: str, payload: float, n: int) -> float:
    """Wire bytes per device of one collective of reference kind ``kind``
    (``KINDS``' values) on a group of ``n``."""
    if kind == "all-reduce":
        return 2.0 * payload * (n - 1) / max(n, 1)
    if kind in ("all-gather", "scatter", "gather"):
        return payload * (n - 1) / max(n, 1)
    if kind == "collective-permute":
        return float(payload)
    raise ValueError(f"unknown collective kind {kind!r}")


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0               # per device
    by_kind: dict = dataclasses.field(default_factory=dict)
    op_count: int = 0

    def to_dict(self) -> dict:
        return {"wire_bytes": self.wire_bytes, "by_kind": dict(self.by_kind),
                "op_count": self.op_count}


def collective_stats(records: Iterable[CollectiveRecord]) -> CollectiveStats:
    stats = CollectiveStats()
    for rec in records:
        kind = KINDS[rec.kind]
        wire = wire_bytes(kind, rec.payload, rec.group)
        stats.wire_bytes += wire
        stats.by_kind[kind] = stats.by_kind.get(kind, 0.0) + wire
        stats.op_count += 1
    return stats
