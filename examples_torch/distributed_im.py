"""End-to-end driver (the paper's kind of workload) on the port: distributed
influence maximization over a larger synthetic social network on a 2x4
process mesh, with FASST sample-space tasking, ring-schedule propagation,
quality validation, and the paper's Table-5/7 metrics printed along the way.

    PYTHONPATH=src python examples_torch/distributed_im.py                # on the card
    PYTHONPATH=src python examples_torch/distributed_im.py --device cpu   # plain versions

Outside a process group it re-executes its own command line once per rank
under ``python -m torch.distributed.run --standalone --nproc-per-node 8``;
each rank joins the group (``launch.mesh.init_world``: gloo on the CPU and
where ranks share a card, NCCL where each has a card of its own), so
``backend="auto"`` takes the mesh. Rank 0 alone prints the lines of
``examples/distributed_im.py`` and runs the single-device, RIS and oracle
parts after the mesh run.
"""
import argparse
import os
import sys
import time

import torch.distributed as dist

from repro_torch.baselines import influence_score, ris_find_seeds
from repro_torch.core.fasst import build_partition, duplication_histogram, max_shard_fraction
from repro_torch.core.sampling import make_x_vector
from repro_torch.device import resolve_device
from repro_torch.graphs import rmat_graph
from repro_torch.launch import mesh as launch_mesh
from repro_torch.runtime import RunSpec, run as run_im

K, J = 20, 512
RANKS = 8   # the 2 x 4 grid, one shard a rank
# 2-way vertex x 4-way sample-space grid; "auto" picks the mesh under a
# process group of 8 ranks, else the serial-ring twin
SPEC = RunSpec(num_registers=J, seed=0, schedule="ring", mu_v=2, mu_s=4)


def make_graph():
    return rmat_graph(12, edge_factor=8, seed=7, setting="u01")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the CUDA kernels; cpu their plain versions")
    device = resolve_device(ap.parse_args().device)   # raises before any rank starts
    if not launch_mesh.env_world():
        # ``sys.orig_argv`` is the whole command line, with whatever wrapper
        # started this script, which ``sys.argv`` has dropped
        os.execv(sys.executable, [sys.executable, "-m", "torch.distributed.run",
                                  "--standalone", "--nproc-per-node", str(RANKS),
                                  "--no-python", sys.executable, *sys.orig_argv[1:]])
    launch_mesh.init_world(device=device)
    rank = dist.get_rank()

    graph = make_graph()
    if rank == 0:
        print(f"graph: n={graph.n:,} m={graph.m_real:,} (RMAT, U(0,0.1) weights)")

        # --- FASST structural metrics (paper Tables 5/7) ---
        x = make_x_vector(J, seed=0)
        for method in ("naive", "fasst"):
            part = build_partition(graph, x, 4, method=method, device=device)
            hist = duplication_histogram(graph, part, device=device)
            print(f"{method:6s}: max-shard {max_shard_fraction(graph, part)*100:4.0f}% of "
                  f"edges; exactly-1-shard {hist[1]*100:4.0f}%")

    # --- sharded run on the 2x4 grid (SPEC) ---
    try:
        t0 = time.time()
        dreport = run_im(graph, K, SPEC, device=device)
        t_dist = time.time() - t0
    finally:
        launch_mesh.shutdown_world()
    if rank != 0:
        return
    dres = dreport.result
    print(f"\nsharded (2x4 {dreport.backend}, ring): {t_dist:.1f}s "
          f"spread={dres.scores[-1]:.0f} rebuilds={int(dres.rebuilds.sum())}/{K}")

    # --- single-device reference: must agree bit-for-bit ---
    t0 = time.time()
    sres = run_im(graph, K, SPEC.with_(backend="single"), device=device).result
    print(f"single-device:                {time.time()-t0:.1f}s "
          f"spread={sres.scores[-1]:.0f}")
    assert (sres.seeds == dres.seeds).all(), "distributed != single-device!"
    print("distributed == single-device: bitwise identical seeds")

    # --- quality vs the RIS/IMM baseline (gIM/cuRipples family) ---
    ris_seeds, _ = ris_find_seeds(graph, K, num_rr_sets=4000)
    o_ours = influence_score(graph, dres.seeds, num_sims=100)
    o_ris = influence_score(graph, ris_seeds, num_sims=100)
    print(f"oracle: difuser={o_ours:.0f} ris={o_ris:.0f} "
          f"(quality ratio {o_ours/o_ris:.3f}; paper reports ~1.00-1.02x)")


if __name__ == "__main__":
    main()
