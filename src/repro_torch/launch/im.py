"""DiFuseR driver of the port, the workload end to end::

    PYTHONPATH=src python -m repro_torch im --graph rmat:20 --setting 0.1 \
        --k 50 --registers 1024 [--model wc] [--device cuda|cpu]

It prints what the reference launcher prints (``graph n=… m=…``, then
``difuser: …s influence(est)=… rebuilds=…/K``) and a line on where the time
went.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.launch.common import add_common_im_args, make_graph


def run(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch im")
    add_common_im_args(ap)
    ap.add_argument("--k", type=int, default=50)
    return _run(ap.parse_args(argv))


def _run(args) -> dict:
    from repro_torch.runtime import RunSpec, run as run_im

    g = make_graph(args.graph, args.setting, args.seed)
    print(f"graph n={g.n:,} m={g.m_real:,}")
    spec = RunSpec(num_registers=args.registers, seed=args.seed, model=args.model)
    t0 = time.time()
    report = run_im(g, args.k, spec, device=args.device)
    dt = time.time() - t0
    res = report.result
    st = res.stats
    print(f"device={report.device}")
    print(f"difuser: {dt:.2f}s influence(est)={res.scores[-1]:.1f} "
          f"rebuilds={int(res.rebuilds.sum())}/{args.k}")
    print(f"prep: {st['prep_s']:.3f}s; build: {st['build_s']:.3f}s "
          f"sweeps={res.propagate_iters}; "
          f"rounds: {st['rounds_s']:.3f}s cascade sweeps={st['cascade_sweeps']} "
          f"rebuild sweeps={st['rebuild_sweeps']}")
    return dict(device=report.device, time_s=dt,
                n=g.n, m=g.m_real, seeds=res.seeds.tolist(),
                difuser_score=float(res.scores[-1]),
                rebuilds=int(res.rebuilds.sum()),
                propagate_iters=res.propagate_iters, **st)


if __name__ == "__main__":
    run()
