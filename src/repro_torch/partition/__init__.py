"""Load-balanced 2-D partition and the serial-ring executor.

* ``plan``    ``PartitionPlan`` and the vertex-assignment strategies
  (``block``, ``degree``, ``edge``, ``random``), host relabelings, and the
  FASST sample sets (``sample_edge_sets``) on the device;
* ``cost``    the cost model (edge and bucket imbalance, pad waste, ring
  bytes), predicted at plan time and measured after the build;
* ``builder`` ``build_partition_2d``: plan -> bucketed, padded arrays;
* ``shard``   ``build_shard_2d``: one ``(v, s)`` shard's work lists and the
  whole partition's counts and shapes, a chunk of edges at a time (a mesh
  rank's prep);
* ``serial``  the serial-ring executor, the 2-D ring schedule on one device,
  and its shard-restricted delta repair (``repair_plan_shards``).
"""
from repro_torch.partition.builder import Partition2D, build_partition_2d
from repro_torch.partition.cost import PlanStats, measure_partition
from repro_torch.partition.plan import (PartitionPlan, SampledEdges,
                                        available_strategies, plan_partition,
                                        register_strategy, sample_edge_sets)
from repro_torch.partition.serial import (build_matrix_ring_serial, find_seeds_ring_serial,
                                          repair_plan_shards)

__all__ = [
    "Partition2D",
    "PartitionPlan",
    "PlanStats",
    "SampledEdges",
    "available_strategies",
    "build_matrix_ring_serial",
    "build_partition_2d",
    "find_seeds_ring_serial",
    "measure_partition",
    "plan_partition",
    "register_strategy",
    "repair_plan_shards",
    "sample_edge_sets",
]
