"""Influence serving launcher of the port: one sketch build amortized over a
query stream::

    PYTHONPATH=src python -m repro_torch serve --graph rmat:12 \\
        --registers 512 --queries 1000 --topk 10 [--device cuda|cpu]

It builds the ``SketchStore`` index once through the ``--backend`` of
choice, pushes a mixed stream of TopKSeeds / SpreadEstimate / MarginalGain /
CoverageProbe requests through the batched ``InfluenceEngine``, and reports
qps, p50/p99 and the amortized cost of a query against the cold
``find_seeds``. The printed lines and the returned keys are the reference
launcher's (``src/repro/launch/serve_im.py``).

``--residency device`` (or ``--backend mesh``, whose ``auto`` residency is
the device) serves from plan-order row blocks placed on a serving mesh of
``--plan-shards`` ranks, with shard-local query reductions, and prints the
``device-resident: …`` line; the spec then takes ``mu_v=--plan-shards``.
It runs under torchrun::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch serve --graph rmat:12 --residency device --plan-shards 2

Every rank makes the graph; rank 0 is the serving world's controller
(``launch.mesh.serve_world``), serves and prints, and the other ranks follow
its operations until it stops them. Without a process group ``--residency
device`` raises ``BackendUnavailable`` with the reason: the launcher never
serves host-order in its place. ``--answers OUT.json`` writes each query's
answer (floats exactly, as JSON), so two runs' answers can be compared.

``--async`` serves the stream through the ``AsyncInfluenceEngine`` (futures,
deadline-driven micro-batching with a flush window of ``--deadline-ms`` / 4,
``--max-resident`` MB of resident store bytes), whose answers are byte-equal
to the synchronous engine's; it prints the ``async:`` line and returns the
``admission`` summary. ``--trace OUT.json`` and ``--metrics OUT.jsonl``
record the run's spans and metrics. ``--tuning cached|auto`` runs the
index's backend at the tuning cache's winners (``repro_torch.tune``); the
answers are those of ``--tuning off``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.launch.common import add_common_im_args, make_graph, observe
from repro_torch.service import (AsyncInfluenceEngine, CoverageProbe, InfluenceEngine,
                                 MarginalGain, SketchStore, SpreadEstimate, TopKSeeds,
                                 summarize_latencies)


def make_workload(n: int, num_queries: int, *, k: int, seed: int,
                  mix=(0.05, 0.45, 0.35, 0.15)) -> list:
    """A mixed query stream: (topk, spread, marginal, probe) fractions."""
    rng = np.random.default_rng(seed)
    kinds = rng.choice(4, size=num_queries, p=np.asarray(mix) / sum(mix))
    out = []
    for kind in kinds:
        if kind == 0:
            out.append(TopKSeeds(k))
        elif kind == 1:
            size = int(rng.integers(1, 9))
            out.append(SpreadEstimate(rng.integers(0, n, size)))
        elif kind == 2:
            size = int(rng.integers(0, 6))
            out.append(MarginalGain(int(rng.integers(0, n)), rng.integers(0, n, size)))
        else:
            out.append(CoverageProbe(rng.integers(0, n, int(rng.integers(1, 5)))))
    return out


def run(argv=None, *, return_session: bool = False):
    """Parse ``argv`` and serve. Returns the summary dict, or ``(summary,
    InfluenceSession, results)`` with ``return_session=True``: the session
    holds the warm store, for a caller that goes on with deltas, and
    ``results`` are the stream's ``QueryResult``s in submission order."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch serve")
    add_common_im_args(ap, registers_default=512)
    ap.add_argument("--banks", type=int, default=1)
    ap.add_argument("--attach-plan", action="store_true",
                    help="attach a vertex-shard plan of the --partition strategy even "
                         "for the default 'block' (any other --partition attaches "
                         "one); deltas then report the plan shards they touch")
    ap.add_argument("--plan-shards", type=int, default=8,
                    help="vertex shards of the attached plan (and the row blocks of a "
                         "device-resident placement)")
    ap.add_argument("--residency", default="auto", choices=["auto", "host", "device"],
                    help="where the index banks live for serving: 'device' places "
                         "plan-order row blocks on a serving mesh (shard-local query "
                         "reductions; under torchrun); 'auto' follows the resolved "
                         "--backend (mesh -> device)")
    ap.add_argument("--queries", type=int, default=1000)
    ap.add_argument("--topk", type=int, default=10, help="k of the TopKSeeds queries")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--async", dest="serve_async", action="store_true",
                    help="serve through the AsyncInfluenceEngine: futures and "
                         "deadline-driven micro-batching (answers byte-equal to "
                         "the synchronous engine's)")
    ap.add_argument("--deadline-ms", type=float, default=50.0,
                    help="end-to-end deadline of a query under --async (flush "
                         "window = deadline / 4; misses are counted and watched)")
    ap.add_argument("--max-resident", type=float, default=0.0,
                    help="budget in MB of the store's resident bytes (and the "
                         "cross-entry stack) under --async "
                         "(0: none); cost-aware eviction keeps the store under it")
    ap.add_argument("--save", default="", help="write the index npz here")
    ap.add_argument("--answers", default="", metavar="OUT.json",
                    help="write each query's answer here (JSON, in stream order)")
    args = ap.parse_args(argv)
    import torch.distributed as dist

    from repro_torch.launch import mesh as launch_mesh

    joined = launch_mesh.env_world() and not dist.is_initialized()
    if joined:
        launch_mesh.init_world(device=args.device)
    try:
        if dist.is_initialized() and launch_mesh.current_controller() is None:
            # a serving world: every rank makes the graph, rank 0 serves
            g = make_graph(args.graph, args.setting, args.seed)
            served = launch_mesh.serve_world(lambda: _observed(args, g), graphs=[g])
            if served is None:
                return None          # a follower, stopped by rank 0
        else:
            served = _observed(args, None)
    finally:
        if joined:
            launch_mesh.shutdown_world()
    out, sess, results = served
    return (out, sess, results) if return_session else out


def _observed(args, g):
    with observe(args):
        return _run(args, g)


def _answer(result):
    """A query's answer as JSON values (a float32 is exact as a float)."""
    v = result.value
    if isinstance(v, dict):
        return {"est": v["est"].tolist(), "max_register": v["max_register"].tolist()}
    if hasattr(v, "seeds"):
        return {f: np.asarray(getattr(v, f)).tolist()
                for f in ("seeds", "est_gains", "scores", "rebuilds")}
    return float(v)


def _run(args, g=None):
    from repro_torch.partition import plan_partition
    from repro_torch.runtime import InfluenceSession, RunSpec

    if g is None:
        g = make_graph(args.graph, args.setting, args.seed)
    print(f"graph n={g.n:,} m={g.m_real:,} model={args.model}")
    # a sharded spec (mu_v = --plan-shards) only when the run wants the device
    wants_device = args.backend == "mesh" or args.residency == "device"
    spec = RunSpec(num_registers=args.registers, seed=args.seed, model=args.model,
                   backend=args.backend, residency=args.residency,
                   mu_v=args.plan_shards if wants_device else 1, mu_s=1,
                   partition=args.partition if args.partition else "block",
                   serve_async=args.serve_async, deadline_ms=args.deadline_ms,
                   max_resident_mb=args.max_resident, tuning=args.tuning)
    store = SketchStore(num_banks=args.banks, spec=spec, device=args.device)
    sess = InfluenceSession(g, spec, store=store, device=args.device)
    print(f"device={sess.device}")

    # cold reference: what every query would pay without the store
    t0 = time.perf_counter()
    cold = sess.find_seeds(args.topk)
    cold_s = time.perf_counter() - t0
    print(f"cold find_seeds [{sess.last_report.backend}]: {cold_s:.2f}s "
          f"(build fixpoint {cold.propagate_iters} sweeps)")

    engine = InfluenceEngine(store, max_batch=args.max_batch)
    entry = sess.entry()
    key = entry.key
    print(f"store build: {entry.build_time_s:.2f}s "
          f"({entry.num_banks} bank(s), {entry.build_iters} sweeps)")
    if entry.residency == "device":
        pm = entry.planned_matrix()
        shard_bytes = pm.shape[0] // entry.plan.mu_v * pm.shape[1]
        print(f"device-resident: {entry.plan.mu_v} row blocks x {shard_bytes} B on mesh "
              f"{dict(zip(entry.mesh.axis_names, entry.mesh.shape))} "
              f"(serving {entry.serving_backend})")
    elif args.attach_plan or args.partition != "block":
        plan = plan_partition(entry.graph, args.plan_shards, mu_s=1, strategy=args.partition,
                              x=entry.x, seed=args.seed, model=args.model,
                              device=sess.device)
        store.attach_plan(key, plan)
        pm = entry.planned_matrix()
        shard_bytes = pm.shape[0] // plan.mu_v * pm.shape[1]
        print(f"plan attached: {plan.predicted.describe()} "
              f"({plan.mu_v} row blocks x {shard_bytes} B resident)")

    workload = make_workload(g.n, args.queries, k=args.topk, seed=args.seed + 7)
    admission = {}
    if spec.serve_async:
        with AsyncInfluenceEngine(engine, spec=spec) as aeng:
            t0 = time.perf_counter()
            futures = [aeng.submit(key, q) for q in workload]
            aeng.drain()
            wall_s = time.perf_counter() - t0
            results = [f.result() for f in futures]
            admission = aeng.admission_summary()
        print(f"async: deadline {aeng.deadline_ms:.0f}ms  "
              f"e2e p99 {admission['e2e_p99_ms']:.2f}ms  "
              f"miss rate {admission['deadline_miss_rate']:.1%}  "
              f"flushes {admission['flushes']}")
    else:
        for q in workload:
            engine.submit(key, q)
        t0 = time.perf_counter()
        results = engine.run()
        wall_s = time.perf_counter() - t0
    stats = summarize_latencies(results)

    amortized = wall_s / max(args.queries, 1)
    speedup = cold_s / amortized if amortized > 0 else float("inf")
    print(f"served {args.queries} queries in {wall_s:.2f}s "
          f"({args.queries / wall_s:.0f} qps)")
    print(f"p50 {stats['p50_ms']:.2f}ms  p99 {stats['p99_ms']:.2f}ms  "
          f"topk cache hits {stats['cache_hits']}")
    print(f"amortized {amortized * 1e3:.2f}ms/query vs cold {cold_s:.2f}s "
          f"-> {speedup:.0f}x")
    if args.save:
        store.save(args.save, key)
        print(f"index saved to {args.save}")
    if args.answers:
        with open(args.answers, "w") as f:
            json.dump([_answer(r) for r in results], f)
    # stats first: its amortized qps (a memo hit costs 0 s) must not
    # overwrite the wall-clock qps printed above
    out = {**stats, "cold_s": cold_s, "build_s": entry.build_time_s, "wall_s": wall_s,
           "qps": args.queries / wall_s, "amortized_s": amortized, "speedup": speedup,
           "backend": sess.last_report.backend, "residency": entry.residency,
           "serving": entry.serving_backend}
    if admission:
        admission.pop("queue_depth_timeline", None)
        out["admission"] = admission
    return out, sess, results


if __name__ == "__main__":
    run()
