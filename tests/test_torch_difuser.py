"""The port's single-device slice (build + K seed rounds) against the
reference's ``single`` backend, on the CPU: the matrix byte for byte, seeds,
rebuilds and sweep counts exactly, gains and scores to rtol 1e-6."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import two_torch_threads  # noqa: F401  (autouse)
from repro.core import difuser as R
from repro.graphs import rmat_graph as ref_rmat
from repro_torch.core import difuser as T
from repro_torch.core import state
from repro_torch.graphs import rmat_graph as port_rmat
from repro_torch.kernels import counters
from repro_torch.runtime import RunSpec, run

MODELS = ["wc", "ic:0.1", "lt", "dic:1.0"]


def _graphs(scale, setting="w1", seed=3):
    return (ref_rmat(scale, seed=seed, setting=setting),
            port_rmat(scale, seed=seed, setting=setting))


def _cfgs(num_regs, model, **kw):
    return (R.DiFuserConfig(num_registers=num_regs, seed=1, model=model, **kw),
            T.DiFuserConfig(num_registers=num_regs, seed=1, model=model, **kw))


def _same_result(want, got):
    np.testing.assert_array_equal(got.seeds, want.seeds)
    np.testing.assert_array_equal(got.rebuilds, want.rebuilds)
    assert got.propagate_iters == want.propagate_iters
    np.testing.assert_allclose(got.est_gains, want.est_gains, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.x, want.x)
    assert got.seeds.dtype == np.int32 and got.scores.dtype == np.float32


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("scale,num_regs", [(8, 64), (9, 256)])
def test_build_matrix_byte_identical(model, scale, num_regs):
    rg, tg = _graphs(scale)
    rc, tc = _cfgs(num_regs, model)
    want, want_iters, _ = R.build_sketch_matrix(rg, rc)
    got, iters, _ = T.build_sketch_matrix(tg, tc, device="cpu")
    assert iters == want_iters
    assert got.dtype == torch.int8 and got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("model", ["wc", "lt"])
def test_build_matrix_banks_and_warm_start(model):
    rg, tg = _graphs(8)
    rc, tc = _cfgs(64, model)
    x = R.normalize_x(rc, None)
    for b in range(2):  # bank b fills register slots from b * 32
        xb = x[b * 32:(b + 1) * 32]
        want, want_iters, _ = R.build_sketch_matrix(rg, rc, xb, reg_offset=b * 32)
        got, iters, _ = T.build_sketch_matrix(tg, tc, xb, reg_offset=b * 32, device="cpu")
        assert iters == want_iters
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # warm start: a fill without propagation, then the fixpoint from it
    init = np.asarray(R._init_registers(rg.n_pad, rg.n, 64))
    init = np.asarray(R.ops.sketch_fill(init, reg_offset=0, seed=1, impl="ref"))
    want, want_iters, _ = R.build_sketch_matrix(rg, rc, init_matrix=init)
    got, iters, _ = T.build_sketch_matrix(tg, tc, init_matrix=init, device="cpu")
    assert iters == want_iters
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("scale,num_regs,k", [(8, 64, 6), (10, 256, 8)])
def test_find_seeds_matches_reference(model, scale, num_regs, k):
    if model == "lt" and scale == 10:
        scale, k = 9, 4   # lt sweeps many times; keep the CPU run short
    rg, tg = _graphs(scale)
    rc, tc = _cfgs(num_regs, model)
    want = R._find_seeds_single(rg, k, rc)
    counters.reset()
    got = T.find_seeds(tg, k, tc, device="cpu")
    _same_result(want, got)
    assert not counters.LAUNCHES and len(counters.PLAIN_CALLS) == 4
    assert got.stats["cascade_sweeps"] >= k and got.stats["build_s"] >= 0


def test_find_seeds_matches_reference_at_chip_registers():
    """The chip's register count, J = 1024, over K = 50 rounds: the port sums
    the HLL statistic exactly in int64 and the reference in float32, so a
    near-tie in the argmax could part them; the seeds must not."""
    rg, tg = _graphs(11)
    rc, tc = _cfgs(1024, "wc")
    want = R._find_seeds_single(rg, 50, rc)
    got = T.find_seeds(tg, 50, tc, device="cpu")
    _same_result(want, got)


@pytest.mark.parametrize("kw", [dict(rebuild_threshold=0.0),dict(rebuild_threshold=float("inf")),
                                dict(sort_x=False), dict(max_propagate_iters=3,
                                                         max_cascade_iters=2)])
def test_find_seeds_knobs(kw):
    rg, tg = _graphs(8, setting="u01", seed=5)
    rc, tc = _cfgs(128, "wc", **kw)
    _same_result(R._find_seeds_single(rg, 5, rc), T.find_seeds(tg, 5, tc, device="cpu"))


def test_fm_mean_estimator_matches_reference():
    """The reference reads the HLL sum as a sum of M under fm_mean; the
    port does the same."""
    rg, tg = _graphs(8)
    rc, tc = _cfgs(64, "wc", estimator="fm_mean")
    _same_result(R._find_seeds_single(rg, 4, rc), T.find_seeds(tg, 4, tc, device="cpu"))


@pytest.mark.parametrize("model", ["wc", "lt", "dic:1.0"])
def test_warm_from_reference_matrix(model):
    rg, tg = _graphs(8)
    rc, tc = _cfgs(64, model)
    k = 5
    cold = R._find_seeds_single(rg, k, rc)
    g_sorted, x = R.normalize_inputs(rg, rc)
    matrix, _, _ = R.build_sketch_matrix(g_sorted, rc, x, normalized=True)
    ops = tuple(np.asarray(a) for a in R.edge_operands(g_sorted, rc))
    st = state.from_reference(np.asarray(matrix), x, ops, device="cpu")
    warm = T.find_seeds_warm(tg.sorted_by_dst(), k, tc, matrix=st.matrix, x=st.x,
                             edges=st.edges, device="cpu")
    np.testing.assert_array_equal(warm.seeds, cold.seeds)
    np.testing.assert_allclose(warm.scores, cold.scores, rtol=1e-6, atol=0)
    assert torch.equal(st.matrix, torch.from_numpy(np.array(matrix)))  # left as it was
    m2, x2, ops2 = state.to_numpy(st)
    np.testing.assert_array_equal(m2, np.asarray(matrix))
    np.testing.assert_array_equal(x2, x)
    for a, b in zip(ops2, ops):
        assert a.tobytes() == b.tobytes()


def test_warm_equals_cold_within_the_port():
    _, tg = _graphs(8)
    _, tc = _cfgs(64, "ic:0.1")
    cold = T.find_seeds(tg, 5, tc, device="cpu")
    m, _, x = T.build_sketch_matrix(tg, tc, device="cpu")
    warm = T.find_seeds_warm(tg, 5, tc, matrix=m, x=x, device="cpu")
    np.testing.assert_array_equal(warm.seeds, cold.seeds)
    np.testing.assert_array_equal(warm.scores, cold.scores)


def test_runtime_run_is_the_single_backend():
    _, tg = _graphs(8)
    spec = RunSpec(num_registers=64, seed=1, model="dic:1.0")
    rep = run(tg, 4, spec, device="cpu")
    assert rep.device == "cpu" and rep.spec is spec
    direct = T.find_seeds(tg, 4, spec.difuser_config(), device="cpu")
    np.testing.assert_array_equal(rep.result.seeds, direct.seeds)
    np.testing.assert_array_equal(rep.result.rebuilds, direct.rebuilds)
    np.testing.assert_array_equal(rep.result.scores, direct.scores)
    assert rep.result.propagate_iters == direct.propagate_iters


def test_launcher_runs_on_cpu():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "im", "--graph", "rmat:8", "--k", "3",
         "--registers", "64", "--model", "ic:0.1", "--device", "cpu"],
        capture_output=True, text=True, env=env, check=True, timeout=300).stdout
    lines = out.splitlines()
    assert lines[0].startswith("graph n=256 m=")
    assert any(line.startswith("difuser: ") and "rebuilds=" in line and line.endswith("/3")
               for line in lines), out
