"""Shared CLI surface of the port's launchers: the workload flags, the
graph-spec parser, and the ``--trace``/``--metrics`` observability flags
with the ``observe`` context that serves them."""
from __future__ import annotations

import argparse
import contextlib
import time

from repro_torch.graphs import (barabasi_albert_graph, erdos_renyi_graph,
                                load_snap_edgelist, rmat_graph)
from repro_torch.obs import metrics, trace


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


def add_obs_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The ``--trace``/``--metrics`` group that ``observe`` reads."""
    obs = ap.add_argument_group("observability (repro_torch.obs)")
    obs.add_argument("--trace", default=None, metavar="OUT.json",
                     help="record spans and write Chrome trace-event JSON "
                          "(open in ui.perfetto.dev; one lane per phase)")
    obs.add_argument("--metrics", default=None, metavar="OUT.jsonl",
                     help="write a JSONL metrics snapshot (counters, gauges, "
                          "histograms) at exit")
    return ap


@contextlib.contextmanager
def observe(args):
    """Wrap a launcher run in what ``--trace``/``--metrics`` ask for: start
    the span recorder when a trace path is given; at exit write the Chrome
    trace and the metrics snapshot, and print the span coverage (seconds in
    top-level spans over wall seconds). Without the flags nothing is
    recorded or written."""
    trace_path, metrics_path = args.trace, args.metrics
    rec = trace.get_recorder()
    if trace_path:
        rec.start()
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        wall = time.perf_counter() - t0
        if trace_path:
            rec.stop()
            n = rec.save_chrome_trace(trace_path)
            cov = rec.top_level_seconds() / wall if wall > 0 else 0.0
            print(f"trace: {n} spans -> {trace_path} "
                  f"(lanes: {', '.join(sorted(rec.phases_seen()))}; "
                  f"span coverage {cov * 100:.1f}% of {wall:.2f}s wall)")
        if metrics_path:
            n = metrics.registry().write_jsonl(metrics_path)
            print(f"metrics: {n} series -> {metrics_path}")
