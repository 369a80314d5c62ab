"""Model-zoo smoke check of the port: every registered diffusion model builds
a 1k-vertex sketch end to end through ``repro_torch``.

    PYTHONPATH=src python scripts_torch/check_models.py                # on the card
    PYTHONPATH=src python scripts_torch/check_models.py --device cpu   # plain versions

Run by ``make smoke-torch``. It prints the lines of ``scripts/check_models.py``
and catches a model whose host preprocessing or predicate stopped composing
with the kernels. Exit code is non-zero on any failure; without a CUDA device
and without ``--device cpu`` it raises before the first model.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core.difuser import DiFuserConfig, build_sketch_matrix
from repro_torch.device import resolve_device
from repro_torch.diffusion import available_models, resolve
from repro_torch.graphs import erdos_renyi_graph
from repro_torch.runtime import RunSpec, run as run_im

SMOKE_SPECS = {"ic": "ic:0.1", "wc": "wc", "lt": "lt", "dic": "dic:1.0"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the CUDA kernels; cpu their plain versions")
    device = resolve_device(ap.parse_args(argv).device)
    g = erdos_renyi_graph(1024, avg_degree=8, seed=0, setting="w1")
    failures = 0
    for name in available_models():
        spec = SMOKE_SPECS.get(name, name)
        try:
            mdl = resolve(spec)
            cfg = DiFuserConfig(num_registers=64, seed=0, model=spec)
            m, iters, x = build_sketch_matrix(g, cfg, device=device)
            assert m.shape == (g.n_pad, 64), m.shape
            assert iters >= 1, iters
            # at least one register must carry signal (not all VISITED)
            assert int((m != -1).sum()) > 0
            res = run_im(g, 2, RunSpec.from_config(cfg), device=device).result
            assert len(set(res.seeds.tolist())) == 2
            assert np.isfinite(res.scores).all()
            print(f"check_models.{spec}: ok "
                  f"(build {iters} sweeps, spread {res.scores[-1]:.1f}, "
                  f"context_free_edges={mdl.context_free_edges})")
        except Exception as e:  # noqa: BLE001 — report every model, then fail
            failures += 1
            print(f"check_models.{spec}: FAIL {type(e).__name__}: {e}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
