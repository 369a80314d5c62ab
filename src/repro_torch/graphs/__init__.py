"""Graph substrate of the port: container, generators, SNAP loader (numpy)."""
from repro_torch.graphs.generators import (barabasi_albert_graph,
                                           erdos_renyi_graph, rmat_graph)
from repro_torch.graphs.io import load_snap_edgelist
from repro_torch.graphs.structs import (CSR, Graph, GraphDelta, edge_pair_keys,
                                        pad_to_multiple)

__all__ = ["CSR", "Graph", "GraphDelta", "edge_pair_keys", "pad_to_multiple",
           "rmat_graph", "erdos_renyi_graph", "barabasi_albert_graph",
           "load_snap_edgelist"]
