"""One run of one cell: set-up, the measured window, the check against the
reference, and the result's line.

Set-up (``setup_s``, from the process's start): load the program, make the
configuration's graph on the device from the seed, build the program's
``Graph`` from it, and run one warm-up job at the cell's shapes (K = the
traffic kind's ``WARMUP_K``), which also builds and loads every kernel
library the cell's jobs use. Then the device's peak memory is reset and the window opens: jobs
of the cell's traffic run back to back through
``repro_torch.runtime.run(graph, K, RunSpec(...), device=...)``, the call
that ``python -m repro_torch im`` makes, each started before ``seconds``
have passed and run to its end, which is a device sync. After the window
the program's device state is freed and the reference recomputes the jobs
that the seed samples.

A cell on several cards runs this on every rank of a world
(``harness/world.py``), in step: the ranks agree on the graph, rank 0
decides for every rank whether each job starts, and after the window the
ranks leave the process group, stop their profilers and hand rank 0 their
job counts, peaks and device readings; rank 0 alone checks and returns the
result's line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from imbench.harness import cells, graph
from imbench.harness.check import Outputs, judge, worst
from imbench.harness.profile import Reading, Tracer


@dataclasses.dataclass
class Window:
    """What the metric readers read: the window's jobs, its length, the
    set-up time, the device's peak, and with ``--trace 1`` the profile."""

    jobs: List[Outputs]
    stats: List[dict]
    k: int
    seconds: float
    setup_s: float
    peak_bytes: int
    n: int
    m: int
    num_registers: int
    model: str
    backend: str
    reading: Optional[Reading] = None


def _outputs(result) -> Outputs:
    return Outputs(seeds=np.asarray(result.seeds), gains=np.asarray(result.est_gains),
                   scores=np.asarray(result.scores), rebuilds=np.asarray(result.rebuilds),
                   build_sweeps=int(result.propagate_iters),
                   cascade_sweeps=int(result.stats["cascade_sweeps"]),
                   rebuild_sweeps=int(result.stats["rebuild_sweeps"]))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Solo:
    """The one process of a one-card cell: nothing to share."""

    lead = True

    def agree_graph(self, edges, what: dict) -> None:
        pass

    def barrier(self) -> None:
        pass

    def next_job(self, wanted: bool, index: int):
        return wanted, index

    def leave(self) -> None:
        pass

    def gather(self, reading: dict) -> list:
        return [reading]


def run_cell(cell: cells.Cell, *, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=None, marks=None, world=None) -> Optional[dict]:
    """Run ``cell`` and return the result's line as a dict (on a world's
    rank 0; None on its other ranks). ``marks`` are the host clock's
    readings of set-up's earlier steps, by name; ``world`` is this rank's
    ``harness.world.World``, or None for the one process of a one-card
    cell."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    marks = dict(marks or {})
    world = world or Solo()
    from repro_torch.graphs.structs import Graph
    from repro_torch.runtime import RunSpec, run

    marks["program"] = time.perf_counter()
    dev = torch.device(device)
    torch.zeros(1, device=dev)  # the device's context, timed apart from the graph
    marks["context"] = time.perf_counter()
    edges = graph.make_edges(cell.config, seed, dev)
    world.agree_graph(edges, {"cell": cell.name, "seed": seed, "trace": trace,
                              "seconds": seconds})
    marks["graph"] = time.perf_counter()
    g = Graph.from_edges(*edges)
    marks["Graph"] = time.perf_counter()
    batch = cell.generator().plan(cell.traffic, cell.config, seed)

    def job(k: int, index: int):
        report = run(g, k, RunSpec(**batch.spec_fields(index)), device=dev)
        _sync(dev)
        return report.result

    job(cell.generator().WARMUP_K, -1)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    world.barrier()
    marks["warm-up job"] = time.perf_counter()
    setup_s = marks["warm-up job"] - t_start
    steps, last = [], t_start
    for name, t in marks.items():
        steps.append(f"{name} {t - last:.3f}")
        last = t
    log(f"set-up {setup_s:.3f} s: " + ", ".join(steps)
        + f"; n={edges[0]} m={edges[1].shape[0]}")

    tracer = Tracer(dev) if trace else None
    done: List[Outputs] = []
    stats: List[dict] = []
    if tracer is not None:
        tracer.start()
    t0 = time.perf_counter()
    while True:
        go, index = world.next_job(time.perf_counter() - t0 < seconds, len(done))
        if not go:
            break
        t_job = time.perf_counter()
        with tracer.job() if tracer is not None else contextlib.nullcontext():
            res = job(batch.k, index)
        log(f"job {len(done)}: {time.perf_counter() - t_job:.3f} s "
            + " ".join(f"{k} {v:.3f}" for k, v in res.stats.items() if k.endswith("_s")))
        done.append(_outputs(res))
        stats.append(dict(res.stats))
    window_s = time.perf_counter() - t0
    world.leave()
    if tracer is not None:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window {window_s:.3f} s: {len(done)} jobs of K={batch.k}")
    reading = tracer.read() if tracer is not None else None
    ranks = world.gather({"jobs": len(done), "peak": int(peak),
                          "busy_s": reading and reading.busy_s,
                          "window_s": reading and reading.window_s})
    if ranks is None:  # a rank of a world other than rank 0
        return None
    if len(ranks) > 1:
        reading = _world_reading(reading, ranks)
        log(f"world of {len(ranks)} ranks: jobs {[r['jobs'] for r in ranks]}, peaks "
            f"{[r['peak'] for r in ranks]} B, device busy "
            f"{[r['busy_s'] for r in ranks]} s of {[r['window_s'] for r in ranks]} s")
    del g, res
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    win = Window(jobs=done, stats=stats, k=batch.k, seconds=window_s, setup_s=setup_s,
                 peak_bytes=max(r["peak"] for r in ranks), n=edges[0],
                 m=int(edges[1].shape[0]), num_registers=batch.num_registers,
                 model=batch.model, backend=batch.fields.get("backend", "auto"),
                 reading=reading)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.metric_reader(m["name"])(win)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    rng = np.random.default_rng([seed, 0xC4EC])
    picked = sorted(rng.choice(len(done), size=min(batch.check_jobs, len(done)),
                               replace=False).tolist())
    t_check = time.perf_counter()
    limits = cell.check["limits"]
    per_job = cell.generator().check(batch, done, edges, cell.check, picked, dev)
    verdict = judge(worst(per_job), limits)
    log(f"reference: jobs {picked} in {time.perf_counter() - t_check:.3f} s")
    failed = sum(not all(v["ok"] for v in judge(r, limits).values()) for r in per_job)
    correct = failed == 0 and bool(per_job)

    out = {"correct": correct, "attempted": len(done), "failed": failed,
           "metrics": metrics, "device": _device(dev, cell.chips, win)}
    if win.reading is not None:
        r = win.reading
        out["breakdown"] = {"device_ops": [[n, s] for n, s in r.device_ops],
                            "idle_gaps": [[n, s] for n, s in r.idle_gaps]}
    out["check"] = {name: {"value": v["value"], "limit": v["limit"]}
                    for name, v in verdict.items()}
    for name, v in verdict.items():
        log(f"check {name} {v['value']} limit {v['limit']}")
    return out


def _world_reading(reading: Optional[Reading], ranks: list) -> Optional[Reading]:
    """Rank 0's reading with the device's busy and traced seconds averaged
    over the ranks' cards."""
    if reading is None:
        return None
    return dataclasses.replace(
        reading, busy_s=sum(r["busy_s"] for r in ranks) / len(ranks),
        window_s=sum(r["window_s"] for r in ranks) / len(ranks))


def _device(dev: torch.device, chips: int, win: Window) -> dict:
    cuda = dev.type == "cuda"
    out = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": win.peak_bytes}
    if win.reading is not None:
        out.update(busy_s=win.reading.busy_s, window_s=win.reading.window_s)
    return out
