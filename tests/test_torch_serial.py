"""The port's ``serial`` backend (the 2-D ring schedule on one device)
against the reference's ``serial`` backend, on the CPU: seeds, rebuilds and
sweep counts exactly, gains and scores to rtol 1e-6, across diffusion
models, planners, shard grids and the fused and unfused prologue; the ring's
build matrix byte for byte; and the port's serial seeds against its own
single backend."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import difuser as R_difuser
from repro.graphs import rmat_graph as ref_rmat
from repro.partition import serial as R_serial
from repro.runtime import RunSpec as RSpec
from repro.runtime import run as r_run
from repro_torch.core import difuser as T_difuser
from repro_torch.graphs import rmat_graph as port_rmat
from repro_torch.kernels import counters
from repro_torch.partition import serial as T_serial
from repro_torch.runtime import (BackendUnavailable, RunSpec, get_backend, resolve_backend,
                                 run)

MODELS = ["wc", "ic:0.1", "lt", "dic:1.0"]
#: the ring settings a tuner may pick (the reference's tests/test_property.py)
RING_SETTINGS = [
    {"local_sweeps": 1},
    {"local_sweeps": 2, "pad_mode": "global"},
    {"local_sweeps": 2, "fuse_sweeps": True},
    {"local_sweeps": 2, "fuse_sweeps": True, "lane_fill": 8},
    {"local_sweeps": 1, "fuse_sweeps": True, "lane_fill": 24, "pad_mode": "global"},
]
SERIAL_KERNELS = {"fused_sample", "sketch_fill", "sketch_cardinality", "bucket_propagate",
                  "bucket_cascade"}


def _graphs(scale=7, seed=9):
    return (ref_rmat(scale, edge_factor=6, seed=seed, setting="w1"),
            port_rmat(scale, edge_factor=6, seed=seed, setting="w1"))


def _specs(model, num_regs=64, **kw):
    return (RSpec(num_registers=num_regs, seed=3, model=model, **kw),
            RunSpec(num_registers=num_regs, seed=3, model=model, **kw))


def _same_result(want, got):
    np.testing.assert_array_equal(got.seeds, want.seeds)
    np.testing.assert_array_equal(got.rebuilds, want.rebuilds)
    assert got.propagate_iters == want.propagate_iters
    np.testing.assert_allclose(got.est_gains, want.est_gains, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.x, want.x)


def _both(model, k=4, scale=7, num_regs=64, **kw):
    rg, tg = _graphs(scale)
    rs, ts = _specs(model, num_regs, backend="serial", **kw)
    want = r_run(rg, k, rs)
    counters.reset()
    got = run(tg, k, ts, device="cpu")
    assert got.backend == want.backend == "serial" and got.device == "cpu"
    assert not counters.LAUNCHES
    _same_result(want.result, got.result)
    assert got.partition.stats().describe() == want.partition.stats().describe()
    return want, got


@pytest.mark.parametrize("strategy", ["block", "degree", "random"])
@pytest.mark.parametrize("model", MODELS)
def test_serial_matches_reference_per_planner(model, strategy):
    _, got = _both(model, mu_v=2, mu_s=2, partition=strategy)
    assert set(counters.PLAIN_CALLS) == SERIAL_KERNELS
    assert got.partition.plan.strategy == strategy


@pytest.mark.parametrize("grid", [(2, 1), (1, 2), (3, 2)])
@pytest.mark.parametrize("model", MODELS)
def test_serial_matches_reference_per_grid(model, grid):
    _both(model, mu_v=grid[0], mu_s=grid[1], partition="degree")


@pytest.mark.parametrize("setting", range(len(RING_SETTINGS)))
@pytest.mark.parametrize("model", MODELS)
def test_serial_matches_reference_per_ring_setting(model, setting):
    kw = RING_SETTINGS[setting]
    _both(model, mu_v=2, mu_s=2, partition="degree", **kw)
    if kw.get("fuse_sweeps"):
        assert counters.PLAIN_CALLS["fused_sweep"] > 0


def test_serial_fm_mean_matches_reference():
    """The ring sums M under fm_mean (the single path sums 2^-M): the port
    keeps each backend as the reference has it."""
    _both("wc", mu_v=2, mu_s=2, partition="block", estimator="fm_mean")


def test_serial_knobs_match_reference():
    _both("ic:0.1", k=5, mu_v=2, mu_s=2, partition="degree", rebuild_threshold=0.0,
          max_propagate_iters=3, max_cascade_iters=2)


@pytest.mark.parametrize("model", MODELS)
def test_serial_seeds_equal_single_seeds(model):
    _, tg = _graphs(8, seed=4)
    single = run(tg, 5, RunSpec(num_registers=64, seed=2, model=model), device="cpu")
    serial = run(tg, 5, RunSpec(num_registers=64, seed=2, model=model, mu_v=2, mu_s=2,
                                partition="degree", local_sweeps=2, fuse_sweeps=True),
                 device="cpu")
    assert (single.backend, serial.backend) == ("single", "serial")
    np.testing.assert_array_equal(serial.result.seeds, single.result.seeds)
    np.testing.assert_allclose(serial.result.scores, single.result.scores, rtol=1e-6)


@pytest.mark.parametrize("reg_offset", [0, 64])
@pytest.mark.parametrize("model,strategy,mu_v,mu_s,kw", [
    ("wc", "block", 2, 1, {}), ("lt", "degree", 2, 2, {}),
    ("ic:0.1", "random", 3, 2, {"local_sweeps": 2, "fuse_sweeps": True}),
    ("dic:1.0", "edge", 2, 2, {"local_sweeps": 1})])
def test_build_matrix_ring_serial_byte_equal(model, strategy, mu_v, mu_s, kw, reg_offset):
    rg, tg = _graphs()
    cfg_r = R_difuser.DiFuserConfig(num_registers=64, seed=3, model=model)
    cfg_t = T_difuser.DiFuserConfig(num_registers=64, seed=3, model=model)
    g_r, x = R_difuser.normalize_inputs(rg, cfg_r)
    g_t = tg.sorted_by_dst()
    want, want_iters, _ = R_serial.build_matrix_ring_serial(
        g_r, cfg_r, x, mu_v=mu_v, mu_s=mu_s, strategy=strategy, reg_offset=reg_offset, **kw)
    got, iters, part = T_serial.build_matrix_ring_serial(
        g_t, cfg_t, x, mu_v=mu_v, mu_s=mu_s, strategy=strategy, reg_offset=reg_offset,
        device="cpu", **kw)
    assert iters == want_iters
    assert got.dtype == torch.int8 and got.numpy().tobytes() == np.asarray(want).tobytes()
    single, _, _ = T_difuser.build_sketch_matrix(g_t, cfg_t, x, reg_offset=reg_offset,
                                                 normalized=True, device="cpu")
    assert torch.equal(got, single)


def test_backend_build_matrix_equals_single():
    _, tg = _graphs()
    spec = RunSpec(num_registers=64, seed=3, model="lt", mu_v=2, mu_s=2, partition="degree")
    x = np.sort(np.random.default_rng(0).integers(0, 1 << 32, 64, dtype=np.uint64)
                .astype(np.uint32))
    m_serial, it_serial = get_backend("serial").build_matrix(tg, spec, x, device="cpu")
    m_single, it_single = get_backend("single").build_matrix(tg, spec, x, device="cpu")
    assert it_serial == it_single and torch.equal(m_serial, m_single)
    # a bank narrower than the sim grid stays whole
    m_bank, _ = get_backend("serial").build_matrix(tg, spec, x[:3], reg_offset=5,
                                                   device="cpu")
    want, _ = get_backend("single").build_matrix(tg, spec, x[:3], reg_offset=5, device="cpu")
    assert torch.equal(m_bank, want)


def test_ring_state_buckets_carry_work_lists(monkeypatch):
    """Every bucket of the ring state has its work list, one partial scratch
    at the largest ``num_partials`` serves the bucket merges, and the
    cascade, propagate and local sweeps pass it to every merge."""
    from repro_torch.core.sampling import make_x_vector
    from repro_torch.kernels import ops

    _, tg = _graphs(8, seed=4)
    g = tg.sorted_by_dst()
    cfg = T_difuser.DiFuserConfig(num_registers=64, seed=2)
    x = make_x_vector(64, seed=2)
    part = T_serial._prepare(g, x, cfg, mu_v=2, mu_s=2, strategy="degree", pad_mode="step",
                             device=torch.device("cpu"), stats={})
    st = T_serial._RingState(part, g, cfg)
    buckets = [r for grid in (st.p_rows, st.c_rows) for step in grid for by_v in step
               for r in by_v]
    assert len(buckets) == 2 * part.mu_v * part.mu_v * part.mu_s
    for rows in buckets:
        w = rows.work
        assert w is not None and w.num_items >= part.n_loc
        assert int(w.item_ptr[-1]) == rows.nbr.numel()
    assert tuple(st.partial.shape) == (max(r.work.num_partials for r in buckets), part.j_loc)
    seen = {"bucket_cascade": [], "bucket_propagate": []}

    def spy(name):
        plain = getattr(ops, name)

        def merge(*args, partial=None, **kw):
            seen[name].append(partial)
            return plain(*args, partial=partial, **kw)
        return merge

    for name in seen:
        monkeypatch.setattr(ops, name, spy(name))
    st.sweep_cascade()
    st.sweep_propagate()
    st.sweep_local()
    shards = part.mu_v * part.mu_s
    assert len(seen["bucket_cascade"]) == shards * sum(map(bool, st.c_width))
    assert len(seen["bucket_propagate"]) == shards * (sum(map(bool, st.p_width))
                                                      + bool(st.p_width[0]))
    assert len(seen["bucket_propagate"]) > shards
    assert all(p is st.partial for calls in seen.values() for p in calls)


def test_resolve_backend():
    assert resolve_backend(RunSpec()).name == "single"
    assert resolve_backend(RunSpec(mu_v=2, mu_s=1)).name == "serial"
    assert [get_backend(n).capabilities().distributed
            for n in ("single", "serial", "mesh")] == [False, True, True]
    assert resolve_backend(RunSpec(backend="single", mu_v=2, mu_s=2)).name == "single"
    with pytest.raises(BackendUnavailable, match="not divisible by mu_s=3"):
        resolve_backend(RunSpec(backend="serial", num_registers=64, mu_s=3))
    # the mesh backend needs a process group; this process has none
    with pytest.raises(BackendUnavailable, match="no process group"):
        resolve_backend(RunSpec(backend="mesh"))
    with pytest.raises(KeyError, match="unknown backend"):
        resolve_backend(RunSpec(backend="nope"))


def test_launcher_serial_on_cpu():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "im", "--graph", "rmat:9", "--k", "3",
         "--registers", "64", "--backend", "serial", "--partition", "degree",
         "--device", "cpu"],
        capture_output=True, text=True, env=env, check=True, timeout=300).stdout
    lines = out.splitlines()
    assert lines[0].startswith("graph n=512 m=")
    assert any(line.startswith("backend=serial partition: [measured:degree] edge_imb=")
               for line in lines), out
    assert any(line.startswith("difuser: ") and line.endswith("/3") for line in lines), out
