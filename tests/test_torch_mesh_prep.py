"""A mesh rank's own-shard prep (``partition.shard.build_shard_2d``, through
``core.distributed._rank_partition``) against the whole build, on the CPU.

For every ``(v, s)`` of each grid, the rank's work lists equal, field for
field and byte for byte, the whole build's (``builder.build_partition_2d``
after the serial ring's sampling and planning) cut by ``_shard_rows``; its
partition's counts, widths, x split, owned ids, plan and ``stats()`` equal
the whole partition's, and its bucket tensors are shape-only. The counts
and the plan also equal the reference's whole build (held in one chunk;
the chunks change neither). Each case runs once in one chunk and once in
chunks of 700 edges (at least four, seams inside buckets). No process
group: the mesh is a stand-in with a coordinate and a device.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.graphs import rmat_graph as ref_rmat
from repro.partition import builder as R_builder
from repro.partition import plan as R_plan
from repro_torch.core.distributed import DistributedConfig, _rank_partition
from repro_torch.core.sampling import make_x_vector
from repro_torch.graphs import rmat_graph as port_rmat
from repro_torch.partition import shard
from repro_torch.partition.builder import build_partition_2d
from repro_torch.partition.plan import plan_partition, sample_edge_sets
from repro_torch.partition.serial import _shard_rows

J = 64
#: name -> (rmat scale, mu_v, mu_s, model, method, pad_mode, strategy, plan given)
CASES = {
    "2x2_wc_block": (8, 2, 2, "wc", "fasst", "step", "block", False),
    "1x4_wc_block": (8, 1, 4, "wc", "fasst", "step", "block", False),
    "4x1_wc_degree": (9, 4, 1, "wc", "fasst", "step", "degree", False),
    "3x2_wc_degree_global": (8, 3, 2, "wc", "fasst", "global", "degree", False),
    "2x2_wc_naive": (8, 2, 2, "wc", "naive", "step", "block", False),
    "2x2_lt_degree": (8, 2, 2, "lt", "fasst", "step", "degree", False),
    "3x2_lt_naive_global": (9, 3, 2, "lt", "naive", "global", "block", False),
    "2x2_ic_degree_plan_given": (8, 2, 2, "ic:0.1", "fasst", "step", "degree", True),
    # the serving mesh: a plan_partition(..., mu_s=1) plan on (mu_v, 1)
    "4x1_serving_plan": (9, 4, 1, "wc", "fasst", "step", "block", True),
}
SMALL_CHUNK = 700


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The CPU runs here are tiny; with every core's thread each, beside the
    other test workers, they spend their time in thread hand-offs. One
    thread, restored after."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
_ROW_FIELDS = ("rowptr", "nbr", "h", "lo", "thr")
_WORK_FIELDS = ("item_ptr", "item_row", "item_slot", "split_row", "split_ptr")


def _same_rows(got, want, what):
    for f in _ROW_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f"{what}: {f}"
    for f in _WORK_FIELDS:
        assert torch.equal(getattr(got.work, f), getattr(want.work, f)), f"{what}: work.{f}"
    assert got.work.num_partials == want.work.num_partials, what


def _same_stats(a, b):
    """Two ``PlanStats`` field for field (the per-shard edges exactly)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f.name
        else:
            assert x == y, f.name


def _whole(g, x, mu_v, mu_s, model, method, pad_mode, strategy, plan):
    """The serial ring's prep: sample sets, plan (unless given), buckets."""
    sampled = sample_edge_sets(g, x, mu_s, seed=1, model=model, method=method, device="cpu")
    if plan is None:
        plan = plan_partition(g, mu_v, mu_s=mu_s, strategy=strategy, seed=1, model=model,
                              sampled=sampled)
    return build_partition_2d(g, x, mu_v, mu_s, seed=1, model=model, plan=plan,
                              pad_mode=pad_mode, sampled=sampled)


def _given_plan(g, x, mu_v, mu_s, model, strategy):
    return plan_partition(g, mu_v, mu_s=mu_s, strategy=strategy, x=x, seed=1, model=model,
                          device="cpu")


@pytest.mark.parametrize("chunked", [False, True], ids=["one_chunk", "chunks"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_own_shard_prep_equals_the_whole_builds_cut(name, chunked, monkeypatch):
    scale, mu_v, mu_s, model, method, pad_mode, strategy, given = CASES[name]
    g = port_rmat(scale, seed=3, setting="w1").sorted_by_dst()
    x = make_x_vector(J, seed=1)
    if method == "fasst":
        x = np.sort(x)
    plan = _given_plan(g, x, mu_v, mu_s, model, strategy) if given else None
    whole = _whole(g, x, mu_v, mu_s, model, method, pad_mode, strategy, plan)
    if chunked:
        monkeypatch.setattr(shard, "SHARD_CHUNK", SMALL_CHUNK)
        assert g.m > 3 * SMALL_CHUNK
    cfg = DistributedConfig(num_registers=J, seed=1, model=model, fasst=method == "fasst",
                            partition=strategy, pad_mode=pad_mode)
    p_fields = [getattr(whole, f) for f in ("p_h", "p_w", "p_r", "p_t", "p_l")]
    c_fields = [getattr(whole, f) for f in ("c_h", "c_w", "c_r", "c_t", "c_l")]
    for v in range(mu_v):
        for s in range(mu_s):
            mesh = types.SimpleNamespace(axis_names=("data", "model"), mu_v=mu_v, mu_s=mu_s,
                                         coord=(v, s), device=torch.device("cpu"))
            stats: dict = {}
            part, (p_rows, c_rows) = _rank_partition(g, mesh, cfg, x, plan, stats)
            assert set(stats) == {"sample_s", "plan_s", "buckets_s"}
            want_p = _shard_rows(whole, p_fields, whole.p_counts, v, s)
            want_c = _shard_rows(whole, c_fields, whole.c_counts, v, s)
            for kk in range(mu_v):
                _same_rows(p_rows[kk], want_p[kk], f"({v}, {s}) propagate step {kk}")
                _same_rows(c_rows[kk], want_c[kk], f"({v}, {s}) cascade step {kk}")
            for f in ("n", "n_pad", "n_loc", "j_loc", "mu_v", "mu_s", "pad_mode",
                      "comm_bytes_per_sweep"):
                assert getattr(part, f) == getattr(whole, f), f
            for f in ("x_shards", "owned_ids", "edge_counts", "p_counts", "c_counts"):
                a, b = getattr(part, f), getattr(whole, f)
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
            for f in ("p_h", "p_w", "p_r", "p_t", "p_l", "c_h", "c_w", "c_r", "c_t", "c_l"):
                for a, b in zip(getattr(part, f), getattr(whole, f)):
                    assert a.device.type == "meta" and a.dtype == b.dtype
                    assert a.shape == b.shape, f
            assert part.plan.strategy == whole.plan.strategy
            assert part.plan.perm.tobytes() == whole.plan.perm.tobytes()
            _same_stats(part.plan.predicted, whole.plan.predicted)
            _same_stats(part.stats(), whole.stats())
    if chunked:
        return
    # the counts and the plan are the reference's whole build's
    rg = ref_rmat(scale, seed=3, setting="w1").sorted_by_dst()
    r_sampled = R_plan.sample_edge_sets(rg, x, mu_s, seed=1, model=model, method=method)
    r_plan = (R_plan.plan_partition(rg, mu_v, mu_s=mu_s, strategy=strategy, x=x, seed=1,
                                    model=model) if given else
              R_plan.plan_partition(rg, mu_v, mu_s=mu_s, strategy=strategy, seed=1,
                                    model=model, sampled=r_sampled))
    ref = R_builder.build_partition_2d(rg, x, mu_v, mu_s, seed=1, model=model, plan=r_plan,
                                       pad_mode=pad_mode, sampled=r_sampled)
    assert r_plan.perm.tobytes() == part.plan.perm.tobytes()
    np.testing.assert_array_equal(part.p_counts, ref.p_counts)
    np.testing.assert_array_equal(part.c_counts, ref.c_counts)
    assert [a.shape[-1] for a in part.p_h] == [a.shape[-1] for a in ref.p_h]
    assert [a.shape[-1] for a in part.c_h] == [a.shape[-1] for a in ref.c_h]


def test_own_shard_prep_refuses_what_the_whole_build_refuses():
    g = port_rmat(8, seed=3, setting="w1").sorted_by_dst()
    x = make_x_vector(J, seed=1)
    with pytest.raises(ValueError, match="pad_mode"):
        shard.build_shard_2d(g, x, 2, 2, 0, 0, pad_mode="row", device="cpu")
    with pytest.raises(ValueError, match="sim shards"):
        shard.build_shard_2d(g, x[:63], 2, 2, 0, 0, device="cpu")
    plan = plan_partition(g, 4, device="cpu")
    with pytest.raises(ValueError, match="mu_v=4"):
        shard.build_shard_2d(g, x, 2, 2, 0, 0, plan=plan, device="cpu")
    mesh = types.SimpleNamespace(axis_names=("data", "model"), mu_v=2, mu_s=2, coord=(0, 0),
                                 device=torch.device("cpu"))
    with pytest.raises(ValueError, match="2-way"):
        _rank_partition(g, mesh, DistributedConfig(num_registers=J), x, plan)
