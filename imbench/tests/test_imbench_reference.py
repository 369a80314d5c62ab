"""The plain reference (``imbench/reference/alg4.py``) gives what the
program gives, on the CPU at small sizes: everything on the single path,
for ``wc`` and ``lt``; on the serial ring the outputs it shares with plain
Alg. 4 (seeds, scores, rebuild flags, gains, cascade sweeps), while its
build and rebuild sweeps are the ring's own; there the reference adds the
selection's sums over the ring's simulation shards as the ring does."""
import numpy as np
import pytest
import torch

from imbench.harness.graph import make_edges
from imbench.reference import alg4

GRID = dict(backend="serial", mu_v=2, mu_s=2, partition="degree", local_sweeps=2,
            fuse_sweeps=True, lane_fill=256)
CONFIG = dict(generator="kronecker", edgefactor=16, a=0.57, b=0.19, c=0.19, weight=0.1)


def _both(scale, model, registers, k, hash_seed, spec=None, weight=0.1):
    from repro_torch.graphs.structs import Graph
    from repro_torch.runtime import RunSpec, run

    edges = make_edges(dict(CONFIG, scale=scale, weight=weight), 1000 + scale, "cpu")
    fields = dict(spec or {"backend": "single"}, num_registers=registers, model=model,
                  seed=hash_seed)
    got = run(Graph.from_edges(*edges), k, RunSpec(**fields), device="cpu").result
    want = alg4.find_seeds(*edges, model=model, num_registers=registers, k=k,
                           seed=hash_seed, sim_shards=fields.get("mu_s", 1))
    return got, want


def _row(scale, model, registers, k, hash_seed, weight=0.1):
    name = f"{scale}-{model}-{registers}-{k}-{hash_seed}"
    return pytest.param(scale, model, registers, k, hash_seed, weight,
                        id=name if weight == 0.1 else f"{name}-{weight}")


@pytest.mark.parametrize("scale,model,registers,k,hash_seed,weight", [
    _row(8, "wc", 64, 10, 7), _row(9, "wc", 128, 10, 2 ** 31 - 5), _row(10, "wc", 36, 8, 123),
    _row(8, "lt", 64, 6, 7), _row(9, "lt", 32, 5, 99),
    # Kempe, Kleinberg and Tardos's LT weights, 1 / in-degree: each vertex's
    # intervals cover the whole range, up to float32 rounding
    _row(7, "lt", 64, 6, 7, "inverse_in_degree"),
    _row(8, "lt", 32, 5, 2 ** 31 - 3, "inverse_in_degree"),
    _row(9, "lt", 36, 4, 99, "inverse_in_degree")])
def test_single_path_equals_the_reference(scale, model, registers, k, hash_seed, weight):
    got, want = _both(scale, model, registers, k, hash_seed, weight=weight)
    np.testing.assert_array_equal(got.seeds, want.seeds)
    np.testing.assert_array_equal(got.est_gains, want.gains)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.rebuilds, want.rebuilds)
    assert (got.propagate_iters, got.stats["cascade_sweeps"], got.stats["rebuild_sweeps"]) \
        == (want.build_sweeps, want.cascade_sweeps, want.rebuild_sweeps)


@pytest.mark.parametrize("scale,registers,hash_seed", [(8, 64, 7), (10, 128, 31)])
def test_grid_shares_the_reference_outputs(scale, registers, hash_seed):
    got, want = _both(scale, "wc", registers, 10, hash_seed, GRID)
    np.testing.assert_array_equal(got.seeds, want.seeds)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.rebuilds, want.rebuilds)
    np.testing.assert_array_equal(got.est_gains, want.gains)
    assert got.stats["cascade_sweeps"] == want.cascade_sweeps
    # the ring's comm-free sweeps make its build shorter than plain Alg. 4's
    assert got.propagate_iters < want.build_sweeps


def test_sim_shard_sums_round_twice():
    # shard 0 sums to 1 + 2^-24 (rounded to 1, ties to even), shard 1 to
    # 2^-24: the shards' float32 sum is 1, the whole row's 1 + 2^-23
    m = torch.tensor([[0, 24, 24, alg4.VISITED]], dtype=torch.int8)
    two, count = alg4.row_statistics(m, sim_shards=2)
    one, _ = alg4.row_statistics(m)
    assert two.item() == 1.0 and one.item() == 1.0 + 2.0 ** -23
    assert count.tolist() == [3]
    with pytest.raises(ValueError):
        alg4.row_statistics(m, sim_shards=3)


def test_dedup_merges_parallel_edges_and_drops_loops():
    src, dst, w = alg4.dedup(4, [0, 0, 1, 2, 2], [1, 1, 1, 3, 0], [0.5, 0.5, 0.9, 0.1, 0.2])
    assert src.tolist() == [0, 2, 2] and dst.tolist() == [1, 0, 3]
    np.testing.assert_allclose(w, [0.75, 0.2, 0.1], rtol=1e-6)


def test_lt_intervals_partition_each_vertex():
    dst = np.array([0, 0, 0, 1, 1])
    lo, width = alg4.lt_intervals(2, dst, np.full(5, 0.5, np.float32))
    # vertex 0's in-weights sum to 1.5: three intervals of a third each, no gap
    assert lo[0] == 0 and lo[1] == width[0] and lo[2] == lo[1] + width[1]
    assert abs(int(width[0]) - 2 ** 32 // 3) <= 1
    # vertex 1's sum to 1: two halves
    assert lo[3] == 0 and width[3] == 2 ** 31 and lo[4] == 2 ** 31


def test_kronecker_graph_is_simple_and_seeded():
    cfg = dict(CONFIG, scale=7)
    n, src, dst, w = make_edges(cfg, 5, "cpu")
    assert n == 128 and (src != dst).all() and (w == np.float32(0.1)).all()
    key = src * n + dst
    assert (np.diff(key) > 0).all()
    again = make_edges(cfg, 5, "cpu")
    np.testing.assert_array_equal(again[1], src)
    assert not np.array_equal(make_edges(cfg, 6, "cpu")[1][:50], src[:50])


def test_inverse_in_degree_weights_sum_to_one_per_vertex():
    n, src, dst, w = make_edges(dict(CONFIG, scale=8, weight="inverse_in_degree"), 5, "cpu")
    assert w.dtype == np.float32
    total = np.zeros(n)
    np.add.at(total, dst, w.astype(np.float64))
    has_in = np.bincount(dst, minlength=n) > 0
    np.testing.assert_allclose(total[has_in], 1.0, rtol=1e-6)
    assert (total[~has_in] == 0).all()
    with pytest.raises(ValueError):
        make_edges(dict(CONFIG, scale=6, weight="uniform"), 5, "cpu")


def test_control_is_the_reference_one_precision_lower():
    edges = make_edges(dict(CONFIG, scale=8), 3, "cpu")
    f32 = alg4.find_seeds(*edges, model="wc", num_registers=64, k=8, seed=1)
    bf16 = alg4.find_seeds(*edges, model="wc", num_registers=64, k=8, seed=1,
                           dtype=torch.bfloat16)
    assert not np.array_equal(f32.scores, bf16.scores)
