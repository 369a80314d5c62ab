"""DiFuseR driver of the port, the workload end to end::

    PYTHONPATH=src python -m repro_torch im --graph rmat:20 --setting 0.1 \
        --k 50 --registers 1024 [--model wc] [--device cuda|cpu] \
        [--backend auto|single|serial|mesh] [--devices N] [--mu-v 2] \
        [--schedule ring|allgather] [--no-fasst] [--partition degree] \
        [--tuning off|cached|auto] [--validate] [--ris] [--trace t.json] \
        [--metrics m.jsonl]

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch im --graph rmat:16 --devices 4 --backend mesh

It prints what the reference launcher prints (``graph n=… m=…``, then
``backend=…``, with the measured partition stats on a grid, and ``difuser:
…s influence(est)=… rebuilds=…/K``), a line on where the time went (the
single path's prep split into sort, lower, upload and work lists, the
ring's phase by phase, and the rounds' visited count) and the seeds. The
shard grid follows the reference launcher: ``--devices N`` asks
for ``mu_v`` vertex shards (``--mu-v``, or 2 when N is even) x ``N / mu_v``
sim shards; without it ``--backend serial`` or ``mesh`` takes a ``(mu_v,
2)`` grid, ``mu_v`` from ``--mu-v`` or 2. ``auto`` runs a grid on the
``mesh`` backend where a process group of enough ranks exists, else on
``serial``; an explicit ``--backend mesh`` without one raises.

Under ``torchrun`` (``python -m torch.distributed.run``) every process
joins the process group (``launch.mesh.init_world``: NCCL where each rank
has a card of its own, gloo on the CPU and where ranks share a card) and
runs its shard; only rank 0 prints, adds a ``mesh: world=… grid=…
transport=… devices=…`` line, and writes ``--trace``/``--metrics``.

``--no-fasst`` maps as the reference's does (``sort_x=False,
fasst=False``): the single path keeps x unsorted, the mesh takes the naive
sample partition, and the serial ring sorts whatever it is given.
``--schedule allgather`` swaps the mesh's ring exchange for an all-gather
of the blocks.

``--validate`` scores the seeds with the Monte-Carlo oracle (100
simulations, ``rng_seed = seed + 99``) and ``--ris`` runs the RIS/IMM
baseline (4,000 RR sets) and scores its seeds the same way
(``repro_torch.baselines``, host numpy): the reference launcher's lines and
``oracle_score``, ``ris_time_s``, ``ris_oracle``.

``--tuning cached|auto`` runs the backend at the tuning cache's measured
winners (``repro_torch.tune``; ``auto`` measures a miss first); the seeds
are those of ``--tuning off``.

``--trace OUT.json`` records the drivers' spans (``launch.make_graph``,
``partition.*``, ``single.*``, ``serial.*`` or ``mesh.*``) into a Chrome
trace and prints ``trace: N spans -> … (lanes: …; span coverage …%)``;
``--metrics OUT.jsonl`` writes the metrics snapshot (the planner's gauges
and the measured shard profile among them).
"""
from __future__ import annotations

import argparse
import contextlib
import time

from repro_torch.baselines import influence_score, ris_find_seeds
from repro_torch.launch.common import add_common_im_args, make_graph, observe

#: the single path's ``prep_s`` split as the ``prep:`` line prints it
PREP_PARTS = (("sort", "sort_s"), ("lower", "lower_s"), ("upload", "upload_s"),
              ("work lists", "worklists_s"))


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch im")
    add_common_im_args(ap)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--devices", type=int, default=1,
                    help="shards of the (data, model) grid; the ranks of a mesh run")
    ap.add_argument("--schedule", default="ring", choices=["ring", "allgather"],
                    help="the mesh's exchange of register blocks")
    ap.add_argument("--mu-v", type=int, default=0,
                    help="vertex shards of the grid (0: 2 when --devices is even)")
    ap.add_argument("--no-fasst", action="store_true",
                    help="unsorted x (single), the naive sample partition (mesh)")
    ap.add_argument("--validate", action="store_true", help="score seeds with the MC oracle")
    ap.add_argument("--ris", action="store_true", help="also run the RIS/IMM baseline")
    args = ap.parse_args(argv)
    import torch.distributed as dist

    from repro_torch.launch import mesh as launch_mesh

    joined = launch_mesh.env_world() and not dist.is_initialized()
    if joined:
        launch_mesh.init_world(device=args.device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        with observe(args) if rank == 0 else contextlib.nullcontext():
            return _run(args, rank)
    finally:
        if joined:
            launch_mesh.shutdown_world()


def _grid(args) -> tuple:
    """The reference launcher's shard grid (module doc)."""
    if args.devices > 1:
        mu_v = args.mu_v if args.mu_v > 0 else (2 if args.devices % 2 == 0 else 1)
        if args.devices % mu_v != 0:
            raise SystemExit(f"--devices {args.devices} not divisible by mu_v={mu_v}")
        return mu_v, args.devices // mu_v
    if args.backend in ("serial", "mesh"):
        return (args.mu_v if args.mu_v > 0 else 2), 2
    return 1, 1


def _run(args, rank: int = 0) -> dict:
    from repro_torch.runtime import RunSpec, run as run_im

    say = print if rank == 0 else (lambda *a, **kw: None)
    g = make_graph(args.graph, args.setting, args.seed)
    say(f"graph n={g.n:,} m={g.m_real:,}")
    mu_v, mu_s = _grid(args)
    spec = RunSpec(num_registers=args.registers, seed=args.seed, model=args.model,
                   sort_x=not args.no_fasst, fasst=not args.no_fasst,
                   backend=args.backend, mu_v=mu_v, mu_s=mu_s, partition=args.partition,
                   schedule=args.schedule, tuning=args.tuning)
    t0 = time.time()
    report = run_im(g, args.k, spec, device=args.device)
    dt = time.time() - t0
    res = report.result
    st = res.stats
    if report.partition is not None:
        say(f"backend={report.backend} partition: {report.partition.stats().describe()}")
    else:
        say(f"backend={report.backend}")
    say(f"device={report.device}")
    if report.backend == "mesh":
        from repro_torch.launch.mesh import make_mesh

        say(f"mesh: {make_mesh((mu_v, mu_s), ('data', 'model'), device=args.device).describe()}")
    if args.tuning != "off":
        knobs = (("item_edges", "cascade_item_edges", "item_warps")
                 if report.backend == "single" else
                 ("local_sweeps", "pad_mode", "fuse_sweeps", "lane_fill"))
        say(f"tuning={args.tuning}: "
            + " ".join(f"{f}={getattr(report.spec, f)}" for f in knobs) + " (0: the default)")
    say(f"difuser: {dt:.2f}s influence(est)={res.scores[-1]:.1f} "
        f"rebuilds={int(res.rebuilds.sum())}/{args.k}")
    if "prep_s" in st:   # the single path's prep and its four parts
        prep = f"{st['prep_s']:.3f}s (" + " ".join(
            f"{label} {st[key]:.3f}s" for label, key in PREP_PARTS) + ")"
    else:   # the serial ring's host preparation, phase by phase
        prep = " ".join(f"{key[:-2]} {st[key]:.3f}s" for key in
                        ("sort_s", "sample_s", "plan_s", "buckets_s", "state_s"))
    visited = f" visited {st['visited_s']:.3f}s" if "visited_s" in st else ""
    say(f"prep: {prep}; build: {st['build_s']:.3f}s "
        f"sweeps={res.propagate_iters}; "
        f"rounds: {st['rounds_s']:.3f}s{visited} cascade sweeps={st['cascade_sweeps']} "
        f"rebuild sweeps={st['rebuild_sweeps']}")
    say(f"seeds: {res.seeds.tolist()}")
    out = dict(backend=report.backend, device=report.device, time_s=dt, n=g.n,
               m=g.m_real, seeds=res.seeds.tolist(), difuser_score=float(res.scores[-1]),
               rebuilds=int(res.rebuilds.sum()), propagate_iters=res.propagate_iters, **st)
    if args.validate:
        oracle = influence_score(g, res.seeds, num_sims=100, rng_seed=args.seed + 99,
                                 model=args.model)
        out["oracle_score"] = oracle
        say(f"oracle(difuser seeds) = {oracle:.1f}")
    if args.ris:
        t0 = time.time()
        rs, _ = ris_find_seeds(g, args.k, num_rr_sets=4000, rng_seed=args.seed)
        rt = time.time() - t0
        roracle = influence_score(g, rs, num_sims=100, rng_seed=args.seed + 99)
        out.update(ris_time_s=round(rt, 2), ris_oracle=roracle)
        say(f"ris/imm: {rt:.2f}s oracle={roracle:.1f} "
            f"(quality ratio {out.get('oracle_score', roracle) / max(roracle, 1e-9):.3f})")
    return out


if __name__ == "__main__":
    run()
