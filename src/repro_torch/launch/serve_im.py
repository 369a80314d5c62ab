"""Influence serving launcher of the port: one sketch build amortized over a
query stream::

    PYTHONPATH=src python -m repro_torch serve --graph rmat:12 \\
        --registers 512 --queries 1000 --topk 10 [--device cuda|cpu]

It builds the ``SketchStore`` index once through the ``--backend`` of
choice, pushes a mixed stream of TopKSeeds / SpreadEstimate / MarginalGain /
CoverageProbe requests through the batched ``InfluenceEngine``, and reports
qps, p50/p99 and the amortized cost of a query against the cold
``find_seeds``. The printed lines and the returned keys are the reference
launcher's (``src/repro/launch/serve_im.py``), without its device-residency
and mesh ones, which the port does not have yet.

``--async`` serves the stream through the ``AsyncInfluenceEngine`` (futures,
deadline-driven micro-batching with a flush window of ``--deadline-ms`` / 4,
``--max-resident`` MB of resident store bytes), whose answers are byte-equal
to the synchronous engine's; it prints the ``async:`` line and returns the
``admission`` summary. ``--trace OUT.json`` and ``--metrics OUT.jsonl``
record the run's spans and metrics.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.launch.common import add_common_im_args, add_obs_args, make_graph, observe
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
                    help="vertex shards of the attached plan")
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
    add_obs_args(ap)
    args = ap.parse_args(argv)
    with observe(args):
        out, sess, results = _run(args)
    return (out, sess, results) if return_session else out


def _run(args):
    from repro_torch.partition import plan_partition
    from repro_torch.runtime import InfluenceSession, RunSpec

    g = make_graph(args.graph, args.setting, args.seed)
    print(f"graph n={g.n:,} m={g.m_real:,} model={args.model}")
    spec = RunSpec(num_registers=args.registers, seed=args.seed, model=args.model,
                   backend=args.backend, mu_v=1, mu_s=1,
                   partition=args.partition if args.partition else "block",
                   serve_async=args.serve_async, deadline_ms=args.deadline_ms,
                   max_resident_mb=args.max_resident)
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
    if args.attach_plan or args.partition != "block":
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
