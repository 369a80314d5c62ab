"""The port's FASST sample split, partition planner, bucket builder and cost
model against the reference's ``repro.core.fasst`` and ``repro.partition``,
on the CPU: sample sets, plans and every bucket array byte for byte, the
plan stats equal."""
import dataclasses

import numpy as np
import pytest

from repro.core import fasst as R_fasst
from repro.graphs import rmat_graph as ref_rmat
from repro.partition import builder as R_builder
from repro.partition import plan as R_plan
from repro_torch.core import fasst as T_fasst
from repro_torch.core.sampling import make_x_vector
from repro_torch.graphs import rmat_graph as port_rmat
from repro_torch.partition import builder as T_builder
from repro_torch.partition import plan as T_plan

MODELS = ["wc", "ic:0.1", "lt", "dic:1.0"]
STRATEGIES = ["block", "degree", "edge", "random"]


def _graphs(scale=8, seed=3):
    return (ref_rmat(scale, seed=seed, setting="w1").sorted_by_dst(),
            port_rmat(scale, seed=seed, setting="w1").sorted_by_dst())


def _x(num_regs=64, seed=1):
    return make_x_vector(num_regs, seed=seed)


@pytest.mark.parametrize("method", ["fasst", "naive"])
@pytest.mark.parametrize("mu", [1, 2, 4])
def test_partition_samples(mu, method):
    x = _x(64)
    want = R_fasst.partition_samples(x, mu, method=method)
    got = T_fasst.partition_samples(x, mu, method=method)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mu_s", [1, 2, 3])
def test_sample_edge_sets_equal(model, mu_s):
    rg, tg = _graphs()
    x = _x(48)
    want = R_plan.sample_edge_sets(rg, x, mu_s, seed=1, model=model)
    got = T_plan.sample_edge_sets(tg, x, mu_s, seed=1, model=model, device="cpu")
    assert got.x_shards.tobytes() == want.x_shards.tobytes()
    for a, b in zip(got.masks, want.masks):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in ((got.h, want.ep.h), (got.lo, want.ep.lo), (got.thr, want.ep.thr)):
        assert a.numpy().view(np.uint32).tobytes() == b.tobytes()
    assert any(len(m) for m in want.masks) and any(len(m) < rg.m_real for m in want.masks)


@pytest.mark.parametrize("chunk", [1, 7, 1 << 20])
def test_sampled_by_any_chunking(chunk):
    """Edge chunks of any size give the reference's mask."""
    rg, tg = _graphs(7)
    want = R_plan.sample_edge_sets(rg, _x(32), 2, model="lt")
    got = T_plan.sample_edge_sets(tg, _x(32), 2, model="lt", device="cpu")
    x0 = T_plan._bits(got.x_shards[0], "cpu")
    mask = T_fasst.sampled_by_any(got.h, got.lo, got.thr, x0, variant=1, chunk_edges=chunk)
    np.testing.assert_array_equal(np.nonzero(mask.numpy())[0], want.masks[0])


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mu_v", [1, 2, 3])
def test_plan_partition_byte_equal(strategy, mu_v):
    rg, tg = _graphs()
    x = _x(64)
    want = R_plan.plan_partition(rg, mu_v, mu_s=2, strategy=strategy, seed=1, model="ic:0.1",
                                 sampled=R_plan.sample_edge_sets(rg, x, 2, seed=1,
                                                                 model="ic:0.1"))
    got = T_plan.plan_partition(tg, mu_v, mu_s=2, strategy=strategy, seed=1, model="ic:0.1",
                                sampled=T_plan.sample_edge_sets(tg, x, 2, seed=1,
                                                                model="ic:0.1",
                                                                device="cpu"))
    assert (got.n_pad, got.n_loc, got.mu_v, got.mu_s) == (want.n_pad, want.n_loc,
                                                          want.mu_v, want.mu_s)
    assert got.perm.dtype == want.perm.dtype and got.perm.tobytes() == want.perm.tobytes()
    assert got.inv_perm.tobytes() == want.inv_perm.tobytes()
    np.testing.assert_array_equal(got.owned_ids(), want.owned_ids())
    _same_stats(got.predicted, want.predicted)


@pytest.mark.parametrize("with_x", [False, True])
def test_plan_without_sampled_sets(with_x):
    """Plain degrees without ``x``; with ``x`` the planner samples itself."""
    rg, tg = _graphs()
    x = _x(64) if with_x else None
    want = R_plan.plan_partition(rg, 2, mu_s=2, strategy="degree", x=x)
    got = T_plan.plan_partition(tg, 2, mu_s=2, strategy="degree", x=x, device="cpu")
    assert got.perm.tobytes() == want.perm.tobytes()
    _same_stats(got.predicted, want.predicted)


def test_plan_registry_errors():
    _, tg = _graphs(6)
    with pytest.raises(KeyError, match="unknown partition strategy"):
        T_plan.plan_partition(tg, 2, strategy="nope")
    with pytest.raises(ValueError, match="already registered"):
        T_plan.register_strategy("block", lambda *a: None)
    assert T_plan.available_strategies() == tuple(R_plan.available_strategies())


def _same_stats(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    assert got.describe() == want.describe()


_ARRAYS = ["p_h", "p_w", "p_r", "p_t", "p_l", "c_h", "c_w", "c_r", "c_t", "c_l"]


@pytest.mark.parametrize("pad_mode", ["step", "global"])
@pytest.mark.parametrize("strategy,model,mu_v,mu_s", [
    ("block", "wc", 2, 2), ("degree", "lt", 2, 2), ("random", "ic:0.1", 3, 2),
    ("edge", "dic:1.0", 2, 1), ("degree", "wc", 1, 2), ("degree", "ic:0.1", 3, 4)])
def test_partition_2d_byte_equal(strategy, model, mu_v, mu_s, pad_mode):
    rg, tg = _graphs()
    x = np.sort(_x(64))
    kw = dict(seed=1, model=model)
    r_s = R_plan.sample_edge_sets(rg, x, mu_s, **kw)
    t_s = T_plan.sample_edge_sets(tg, x, mu_s, **kw, device="cpu")
    r_plan = R_plan.plan_partition(rg, mu_v, mu_s=mu_s, strategy=strategy, sampled=r_s, **kw)
    t_plan = T_plan.plan_partition(tg, mu_v, mu_s=mu_s, strategy=strategy, sampled=t_s, **kw)
    want = R_builder.build_partition_2d(rg, x, mu_v, mu_s, plan=r_plan, pad_mode=pad_mode,
                                        sampled=r_s, **kw)
    got = T_builder.build_partition_2d(tg, x, mu_v, mu_s, plan=t_plan, pad_mode=pad_mode,
                                       sampled=t_s, **kw)
    for name in ("n", "n_pad", "n_loc", "j_loc", "mu_v", "mu_s", "comm_bytes_per_sweep",
                 "pad_mode"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("x_shards", "owned_ids", "edge_counts", "p_counts", "c_counts"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for name in _ARRAYS:
        steps_got, steps_want = getattr(got, name), getattr(want, name)
        assert len(steps_got) == len(steps_want) == mu_v
        for a, b in zip(steps_got, steps_want):
            assert tuple(a.shape) == b.shape, name
            assert a.numpy().view(b.dtype).tobytes() == b.tobytes(), name
    _same_stats(got.stats(), want.stats())


def test_partition_2d_default_plan_is_block():
    rg, tg = _graphs(7)
    x = np.sort(_x(32))
    want = R_builder.build_partition_2d(rg, x, 2, 2, model="wc")
    got = T_builder.build_partition_2d(tg, x, 2, 2, model="wc", device="cpu")
    assert got.plan.strategy == "block"
    for name in _ARRAYS:
        for a, b in zip(getattr(got, name), getattr(want, name)):
            assert a.numpy().view(b.dtype).tobytes() == b.tobytes(), name
    with pytest.raises(ValueError, match="pad_mode"):
        T_builder.build_partition_2d(tg, x, 2, 2, pad_mode="none", device="cpu")
