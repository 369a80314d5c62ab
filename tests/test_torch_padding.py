"""Register counts that are not a multiple of 4, against the reference.

The port's kernels move registers four at a time; its drivers pad the
register axis with inert VISITED columns (``core.sketch``) on every device,
so these CPU runs take the padded path the card takes. Held against the
reference's ``single`` and ``serial`` backends: matrices byte for byte,
seeds, rebuilds and sweep counts exactly, gains and scores to rtol 1e-6;
and every operand handed to ``kernels.ops`` is a multiple of 4 wide.
"""
import numpy as np
import pytest
import torch

from _torch_threads import two_torch_threads  # noqa: F401  (autouse)
from repro.core import difuser as R
from repro.core.fasst import _sampled_by_any
from repro.core.sampling import fused_predicate, remix_interval_predicate
from repro.graphs import rmat_graph as ref_rmat
from repro.partition import serial as R_serial
from repro.runtime import RunSpec as RSpec
from repro.runtime import run as r_run
from repro_torch.core import difuser as T
from repro_torch.core import sketch, state
from repro_torch.core.fasst import sampled_by_any
from repro_torch.graphs import rmat_graph as port_rmat
from repro_torch.kernels import counters, ops
from repro_torch.kernels.fused_sample import fused_sample_plain
from repro_torch.partition import serial as T_serial
from repro_torch.runtime import RunSpec, run


def _graphs(scale, setting="w1", seed=3, **kw):
    return (ref_rmat(scale, seed=seed, setting=setting, **kw),
            port_rmat(scale, seed=seed, setting=setting, **kw))


def _cfgs(num_regs, model):
    return (R.DiFuserConfig(num_registers=num_regs, seed=1, model=model),
            T.DiFuserConfig(num_registers=num_regs, seed=1, model=model))


def _same_result(want, got):
    np.testing.assert_array_equal(got.seeds, want.seeds)
    np.testing.assert_array_equal(got.rebuilds, want.rebuilds)
    assert got.propagate_iters == want.propagate_iters
    np.testing.assert_allclose(got.est_gains, want.est_gains, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.x, want.x)


#: where each ``kernels.ops`` function takes its matrices and its x
_OPERANDS = {"sketch_fill": ((0,), None), "cardinality_stats": ((0,), None),
             "propagate_sweep": ((0,), 2), "cascade_sweep": ((0,), 2),
             "fused_sample": ((), 3), "fused_sweep": ((0,), 2),
             "bucket_propagate": ((0, 1), 3), "bucket_cascade": ((0, 1), 3)}


@pytest.fixture
def padded_ops(monkeypatch):
    """Wrap every ``kernels.ops`` function so that it asserts, on each call,
    that the matrices, the partial scratch and x it is given are a multiple
    of 4 wide; returns the calls counted by name."""
    calls = {}

    def wrap(name, fn):
        mats, xi = _OPERANDS[name]

        def checked(*args, **kw):
            widths = [args[i].shape[1] for i in mats]
            if kw.get("partial") is not None:
                widths.append(kw["partial"].shape[1])
            if xi is not None:
                widths.append(args[xi].shape[0])
            assert all(w % 4 == 0 for w in widths), (name, widths)
            assert len(set(widths)) <= 1, (name, widths)
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return checked

    for name in _OPERANDS:
        monkeypatch.setattr(ops, name, wrap(name, getattr(ops, name)))
    return calls


@pytest.mark.parametrize("num_regs", [1, 4, 37, 38, 39, 40])
def test_pad_helpers(num_regs):
    width = sketch.padded_regs(num_regs)
    assert width % 4 == 0 and num_regs <= width < num_regs + 4
    m = torch.from_numpy(np.random.default_rng(num_regs).integers(
        -1, 33, (5, num_regs)).astype(np.int8))
    blank = sketch.blank_matrix(5, num_regs, "cpu")
    assert tuple(blank.shape) == (5, width)
    assert (blank[:, :num_regs] == 0).all() and (blank[:, num_regs:] == -1).all()
    padded = sketch.pad_columns(m, num_regs)
    assert tuple(padded.shape) == (5, width) and (padded[:, num_regs:] == -1).all()
    back = sketch.real_columns(padded, num_regs)
    assert torch.equal(back, m) and back.is_contiguous()
    assert sketch.pad_columns(padded, num_regs) is padded
    assert int(sketch.count_visited(padded, 5, num_regs)) == int((m == -1).sum())
    x = torch.arange(num_regs, dtype=torch.int32)
    xp = sketch.pad_x(x, num_regs)
    assert tuple(xp.shape) == (width,) and torch.equal(xp[:num_regs], x)


@pytest.mark.parametrize("model", ["wc", "lt"])
@pytest.mark.parametrize("num_regs", [37, 38])
def test_single_build_matrix_padded(num_regs, model):
    rg, tg = _graphs(8)
    rc, tc = _cfgs(num_regs, model)
    want, want_iters, _ = R.build_sketch_matrix(rg, rc)
    got, iters, _ = T.build_sketch_matrix(tg, tc, device="cpu")
    assert iters == want_iters
    assert tuple(got.shape) == np.asarray(want).shape and got.is_contiguous()
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("model", ["wc", "ic:0.1", "lt", "dic:1.0"])
@pytest.mark.parametrize("num_regs", [37, 38])
def test_single_find_seeds_padded(num_regs, model, padded_ops):
    rg, tg = _graphs(8)
    rc, tc = _cfgs(num_regs, model)
    want = R._find_seeds_single(rg, 6, rc)
    counters.reset()
    got = T.find_seeds(tg, 6, tc, device="cpu")
    _same_result(want, got)
    assert set(padded_ops) == {"sketch_fill", "cardinality_stats", "propagate_sweep",
                               "cascade_sweep"}


def test_warm_from_padded_reference_matrix(padded_ops):
    rg, tg = _graphs(8)
    rc, tc = _cfgs(37, "wc")
    cold = R._find_seeds_single(rg, 5, rc)
    g_sorted, x = R.normalize_inputs(rg, rc)
    matrix, _, _ = R.build_sketch_matrix(g_sorted, rc, x, normalized=True)
    ops_np = tuple(np.asarray(a) for a in R.edge_operands(g_sorted, rc))
    st = state.from_reference(np.asarray(matrix), x, ops_np, device="cpu")
    warm = T.find_seeds_warm(tg.sorted_by_dst(), 5, tc, matrix=st.matrix, x=st.x,
                             edges=st.edges, device="cpu")
    np.testing.assert_array_equal(warm.seeds, cold.seeds)
    np.testing.assert_array_equal(warm.rebuilds, cold.rebuilds)
    np.testing.assert_allclose(warm.scores, cold.scores, rtol=1e-6, atol=0)
    assert tuple(st.matrix.shape) == np.asarray(matrix).shape   # left as it was
    # a numpy matrix and a fixpoint from a fill (init_matrix) take the same path
    warm_np = T.find_seeds_warm(tg, 5, tc, matrix=np.asarray(matrix), x=x, device="cpu")
    np.testing.assert_array_equal(warm_np.seeds, cold.seeds)
    init = np.asarray(R.ops.sketch_fill(np.asarray(R._init_registers(rg.n_pad, rg.n, 37)),
                                        reg_offset=0, seed=1, impl="ref"))
    want, want_iters, _ = R.build_sketch_matrix(rg, rc, init_matrix=init)
    got, iters, _ = T.build_sketch_matrix(tg, tc, init_matrix=init, device="cpu")
    assert iters == want_iters
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def _serial_graphs():
    return _graphs(7, seed=9, edge_factor=6)


@pytest.mark.parametrize("model", ["wc", "lt"])
@pytest.mark.parametrize("num_regs,kw", [
    (100, {}), (100, {"local_sweeps": 2, "fuse_sweeps": True}),
    (102, {"local_sweeps": 1}), (102, {"local_sweeps": 2, "fuse_sweeps": True})])
def test_serial_padded_matches_reference(num_regs, kw, model, padded_ops):
    rg, tg = _serial_graphs()
    common = dict(num_registers=num_regs, seed=3, model=model, backend="serial", mu_v=2,
                  mu_s=2, partition="degree", **kw)
    want = r_run(rg, 4, RSpec(**common))
    got = run(tg, 4, RunSpec(**common), device="cpu")
    assert got.partition.j_loc == num_regs // 2
    _same_result(want.result, got.result)
    kernels = {"fused_sample", "sketch_fill", "cardinality_stats", "bucket_propagate",
               "bucket_cascade"} | ({"fused_sweep"} if kw.get("fuse_sweeps") else set())
    assert set(padded_ops) == kernels


@pytest.mark.parametrize("num_regs,mu_s", [(100, 2), (102, 2), (37, 1)])
def test_build_matrix_ring_serial_padded(num_regs, mu_s):
    rg, tg = _serial_graphs()
    cfg_r = R.DiFuserConfig(num_registers=num_regs, seed=3, model="wc")
    cfg_t = T.DiFuserConfig(num_registers=num_regs, seed=3, model="wc")
    g_r, x = R.normalize_inputs(rg, cfg_r)
    g_t = tg.sorted_by_dst()
    kw = dict(mu_v=2, mu_s=mu_s, strategy="degree", local_sweeps=2, fuse_sweeps=True)
    want, want_iters, _ = R_serial.build_matrix_ring_serial(g_r, cfg_r, x, **kw)
    got, iters, part = T_serial.build_matrix_ring_serial(g_t, cfg_t, x, device="cpu", **kw)
    assert iters == want_iters and part.j_loc == num_regs // mu_s
    assert got.is_contiguous() and got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("variant", [0, 1])
def test_sampled_by_any_drops_padded_samples(variant, padded_ops):
    rng = np.random.default_rng(31 + variant)
    num_edges, num_samples = 4099, 50

    def u32(n):
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)

    h, lo = u32(num_edges), u32(num_edges)
    thr = u32(num_edges) >> np.uint32(7)
    x = u32(num_samples)
    h_t, lo_t, thr_t, x_t = (torch.from_numpy(a.view(np.int32)) for a in (h, lo, thr, x))
    got = sampled_by_any(h_t, lo_t, thr_t, x_t, variant=variant, chunk_edges=1000)
    want = fused_sample_plain(h_t, lo_t, thr_t, x_t, variant=variant).any(dim=1)
    assert got.dtype == torch.bool and torch.equal(got, want)
    pred = fused_predicate if variant == 0 else remix_interval_predicate
    np.testing.assert_array_equal(got.numpy(),
                                  _sampled_by_any(h, thr, x, lo=lo, predicate=pred))
    assert padded_ops == {"fused_sample": 5}
    # the padding samples (x = 0) do sample edges: kept, they would mark some
    padded = fused_sample_plain(h_t, lo_t, thr_t, sketch.pad_x(x_t, num_samples),
                                variant=variant).any(dim=1)
    assert (padded & ~want).any()
