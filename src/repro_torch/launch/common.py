"""Shared CLI surface of the port's IM launcher: the workload flags and the
graph-spec parser."""
from __future__ import annotations

import argparse

from repro_torch.graphs import (barabasi_albert_graph, erdos_renyi_graph,
                                load_snap_edgelist, rmat_graph)


def make_graph(spec: str, setting: str, seed: int):
    """Parse ``--graph``: rmat:<scale> | rmat-skew:<scale> | er:<n> | ba:<n> |
    snap:<path>."""
    kind, _, arg = spec.partition(":")
    if kind == "rmat":
        return rmat_graph(int(arg), setting=setting, seed=seed)
    if kind == "rmat-skew":
        return rmat_graph(int(arg), edge_factor=8, a=0.65, b=0.15, c=0.15,
                          setting=setting, seed=seed, permute_ids=False)
    if kind == "er":
        return erdos_renyi_graph(int(arg), setting=setting, seed=seed)
    if kind == "ba":
        return barabasi_albert_graph(int(arg), setting=setting, seed=seed)
    if kind == "snap":
        return load_snap_edgelist(arg, setting=setting, seed=seed)
    raise ValueError(spec)


def add_common_im_args(ap: argparse.ArgumentParser, *,
                       registers_default: int = 1024) -> argparse.ArgumentParser:
    grp = ap.add_argument_group("workload")
    grp.add_argument("--graph", default="rmat:12",
                     help="rmat:<scale>|rmat-skew:<scale>|er:<n>|ba:<n>|snap:<path>")
    grp.add_argument("--setting", default="0.1",
                     help="0.005|0.01|0.1|N0.05|U0.1|wc (paper §5)")
    grp.add_argument("--model", default="wc", help="wc|ic[:p]|lt|dic[:lambda]")
    grp.add_argument("--registers", type=int, default=registers_default)
    grp.add_argument("--seed", type=int, default=0)
    grp.add_argument("--partition", default="block",
                     help="vertex-assignment strategy of the 2-D partition: "
                          "block|degree|edge|random")
    grp.add_argument("--backend", default="auto", choices=("auto", "single", "serial"),
                     help="execution backend (auto: single unless a grid is asked for)")
    grp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                     help="cuda runs the CUDA kernels; cpu their plain versions")
    return ap
