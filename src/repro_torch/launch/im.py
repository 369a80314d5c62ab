"""DiFuseR driver of the port, the workload end to end::

    PYTHONPATH=src python -m repro_torch im --graph rmat:20 --setting 0.1 \
        --k 50 --registers 1024 [--model wc] [--device cuda|cpu] \
        [--backend auto|single|serial] [--partition degree] [--mu-v 2] \
        [--tuning off|cached|auto] [--validate] [--ris] [--trace t.json] \
        [--metrics m.jsonl]

It prints what the reference launcher prints (``graph n=… m=…``, then
``backend=…``, with the measured partition stats on ``serial``, and
``difuser: …s influence(est)=… rebuilds=…/K``) and a line on where the time
went. The ``serial`` backend runs a ``(mu_v, 2)`` shard grid, ``mu_v`` from
``--mu-v`` or 2, as the reference launcher does without ``--devices``.

``--validate`` scores the seeds with the Monte-Carlo oracle (100
simulations, ``rng_seed = seed + 99``) and ``--ris`` runs the RIS/IMM
baseline (4,000 RR sets) and scores its seeds the same way
(``repro_torch.baselines``, host numpy): the reference launcher's lines and
``oracle_score``, ``ris_time_s``, ``ris_oracle``.

``--tuning cached|auto`` runs the backend at the tuning cache's measured
winners (``repro_torch.tune``; ``auto`` measures a miss first); the seeds
are those of ``--tuning off``.

``--trace OUT.json`` records the drivers' spans (``launch.make_graph``,
``partition.*``, ``single.*`` or ``serial.*``) into a Chrome trace and
prints ``trace: N spans -> … (lanes: …; span coverage …%)``;
``--metrics OUT.jsonl`` writes the metrics snapshot (the planner's gauges
and the serial ring's measured shard profile among them).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.baselines import influence_score, ris_find_seeds
from repro_torch.launch.common import add_common_im_args, make_graph, observe


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch im")
    add_common_im_args(ap)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--mu-v", type=int, default=0,
                    help="vertex shards of the serial grid (0: 2)")
    ap.add_argument("--validate", action="store_true", help="score seeds with the MC oracle")
    ap.add_argument("--ris", action="store_true", help="also run the RIS/IMM baseline")
    args = ap.parse_args(argv)
    with observe(args):
        return _run(args)


def _run(args) -> dict:
    from repro_torch.runtime import RunSpec, run as run_im

    g = make_graph(args.graph, args.setting, args.seed)
    print(f"graph n={g.n:,} m={g.m_real:,}")
    if args.backend == "serial":
        mu_v, mu_s = (args.mu_v if args.mu_v > 0 else 2), 2
    else:
        mu_v = mu_s = 1
    spec = RunSpec(num_registers=args.registers, seed=args.seed, model=args.model,
                   backend=args.backend, mu_v=mu_v, mu_s=mu_s, partition=args.partition,
                   tuning=args.tuning)
    t0 = time.time()
    report = run_im(g, args.k, spec, device=args.device)
    dt = time.time() - t0
    res = report.result
    st = res.stats
    if report.partition is not None:
        print(f"backend={report.backend} partition: {report.partition.stats().describe()}")
    else:
        print(f"backend={report.backend}")
    print(f"device={report.device}")
    if args.tuning != "off":
        knobs = (("item_edges", "cascade_item_edges", "item_warps")
                 if report.backend == "single" else
                 ("local_sweeps", "pad_mode", "fuse_sweeps", "lane_fill"))
        print(f"tuning={args.tuning}: "
              + " ".join(f"{f}={getattr(report.spec, f)}" for f in knobs) + " (0: the default)")
    print(f"difuser: {dt:.2f}s influence(est)={res.scores[-1]:.1f} "
          f"rebuilds={int(res.rebuilds.sum())}/{args.k}")
    if "prep_s" in st:
        prep = f"{st['prep_s']:.3f}s"
    else:   # the serial ring's host preparation, phase by phase
        prep = " ".join(f"{key[:-2]} {st[key]:.3f}s" for key in
                        ("sort_s", "sample_s", "plan_s", "buckets_s", "state_s"))
    print(f"prep: {prep}; build: {st['build_s']:.3f}s "
          f"sweeps={res.propagate_iters}; "
          f"rounds: {st['rounds_s']:.3f}s cascade sweeps={st['cascade_sweeps']} "
          f"rebuild sweeps={st['rebuild_sweeps']}")
    out = dict(backend=report.backend, device=report.device, time_s=dt, n=g.n,
               m=g.m_real, seeds=res.seeds.tolist(), difuser_score=float(res.scores[-1]),
               rebuilds=int(res.rebuilds.sum()), propagate_iters=res.propagate_iters, **st)
    if args.validate:
        oracle = influence_score(g, res.seeds, num_sims=100, rng_seed=args.seed + 99,
                                 model=args.model)
        out["oracle_score"] = oracle
        print(f"oracle(difuser seeds) = {oracle:.1f}")
    if args.ris:
        t0 = time.time()
        rs, _ = ris_find_seeds(g, args.k, num_rr_sets=4000, rng_seed=args.seed)
        rt = time.time() - t0
        roracle = influence_score(g, rs, num_sims=100, rng_seed=args.seed + 99)
        out.update(ris_time_s=round(rt, 2), ris_oracle=roracle)
        print(f"ris/imm: {rt:.2f}s oracle={roracle:.1f} "
              f"(quality ratio {out.get('oracle_score', roracle) / max(roracle, 1e-9):.3f})")
    return out


if __name__ == "__main__":
    run()
