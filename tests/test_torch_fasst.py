"""FASST's partition and its Table 5-7 metrics (``repro_torch.core.fasst``)
against the reference's ``repro.core.fasst``, on the CPU.

``build_partition``'s arrays are byte-equal (dtype included) for the
``fasst`` and ``naive`` sample partitions under wc and lt;
``duplication_histogram``, ``max_shard_fraction`` and ``lane_fill_rate``
(lanes of 32, the paper's warp, and 128, sorted and unsorted x) are exactly
equal. On the CPU every mask comes from ``fused_sample``'s plain version.
"""
import numpy as np
import pytest

from repro.core import fasst as R
from repro.launch.common import make_graph as ref_graph
from repro_torch.core import fasst as T
from repro_torch.core.sampling import make_x_vector
from repro_torch.kernels import counters
from repro_torch.launch.common import make_graph

MU = 4
SEED = 1


@pytest.fixture(scope="module")
def graphs():
    """(reference graph, port graph, x) at rmat:8 with R = 128 and at
    rmat:9 with R = 256."""
    return {scale: (ref_graph(f"rmat:{scale}", "0.1", 0), make_graph(f"rmat:{scale}", "0.1", 0),
                    make_x_vector(r, seed=3))
            for scale, r in ((8, 128), (9, 256))}


@pytest.mark.parametrize("model", ["wc", "lt"])
@pytest.mark.parametrize("method", ["fasst", "naive"])
def test_build_partition_matches_reference(graphs, method, model):
    rg, tg, x = graphs[8]
    want = R.build_partition(rg, x, MU, method=method, model=model, seed=SEED)
    counters.reset()
    got = T.build_partition(tg, x, MU, method=method, model=model, seed=SEED, device="cpu")
    launched = dict(counters.PLAIN_CALLS)
    # the histogram samples with the legacy wc compare whatever model built
    # the partition, as the reference's does
    np.testing.assert_array_equal(T.duplication_histogram(tg, got, seed=SEED, device="cpu"),
                                  R.duplication_histogram(rg, want, seed=SEED))
    assert launched == {"fused_sample": MU} and not counters.LAUNCHES
    for field in ("x_shards", "perm", "edge_index", "edge_counts"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert (got.method, got.mu, got.regs_per_shard) == (want.method, want.mu,
                                                       want.regs_per_shard)
    assert got.edge_index.shape[1] % 256 == 0
    for t, count in enumerate(got.edge_counts):   # padded with the sentinel edge
        assert (got.edge_index[t, count:] == tg.m - 1).all()


@pytest.fixture(scope="module")
def partitions(graphs):
    """method -> (reference partition, port partition) of the rmat:9 case
    under wc."""
    rg, tg, x = graphs[9]
    return {m: (R.build_partition(rg, x, MU, method=m, seed=SEED),
                T.build_partition(tg, x, MU, method=m, seed=SEED, device="cpu"))
            for m in ("fasst", "naive")}


@pytest.mark.parametrize("method", ["fasst", "naive"])
def test_table_5_to_7_metrics_match_reference(graphs, partitions, method):
    """The lane fill takes x as the method leaves it (sorted for
    ``fasst``)."""
    rg, tg, x = graphs[9]
    want, got = partitions[method]
    hist = T.duplication_histogram(tg, got, seed=SEED, device="cpu")
    assert hist.dtype == np.float64 and hist.shape == (MU + 1,)
    np.testing.assert_array_equal(hist, R.duplication_histogram(rg, want, seed=SEED))
    assert T.max_shard_fraction(tg, got) == R.max_shard_fraction(rg, want)
    xs = np.sort(x) if method == "fasst" else x
    for lane_width in (32, 128):
        assert T.lane_fill_rate(tg, xs, lane_width=lane_width, seed=SEED,
                                device="cpu") == R.lane_fill_rate(
            rg, xs, lane_width=lane_width, seed=SEED)


def test_fasst_shrinks_the_largest_shard_and_fills_more_lanes(graphs, partitions):
    """What Tables 5-7 show under wc: sorting X leaves the largest shard
    fewer edges, fewer edges in every shard, and fuller lanes."""
    _, tg, x = graphs[9]
    parts = {m: p for m, (_, p) in partitions.items()}
    assert T.max_shard_fraction(tg, parts["fasst"]) < T.max_shard_fraction(tg, parts["naive"])
    hists = {m: T.duplication_histogram(tg, p, device="cpu") for m, p in parts.items()}
    assert hists["fasst"][MU] < hists["naive"][MU]
    assert T.lane_fill_rate(tg, np.sort(x), lane_width=32, device="cpu") > T.lane_fill_rate(
        tg, x, lane_width=32, device="cpu")


def test_sampled_by_any_is_independent_of_the_chunk(graphs):
    import torch

    from repro_torch.diffusion import resolve

    _, tg, x = graphs[8]
    ep = resolve("wc").edge_params(tg, seed=SEED)
    h, lo, thr = (T._bits(a, "cpu") for a in (ep.h, ep.lo, ep.thr))
    xs = T._bits(x[:37], "cpu")   # a sample count the kernels pad
    whole = T.sampled_by_any(h, lo, thr, xs, variant=0)
    assert torch.equal(T.sampled_by_any(h, lo, thr, xs, variant=0, chunk_edges=1000), whole)
    want = R._sampled_by_any(ep.h, ep.thr, x[:37], lo=ep.lo)
    np.testing.assert_array_equal(whole.numpy(), want)


def test_build_partition_needs_a_padding_edge_and_whole_lane_tiles():
    from repro_torch.graphs.structs import Graph

    n = 8
    src = np.arange(256, dtype=np.int64) % n
    dst = (src + 1) % n
    g = Graph(n=n, src=src.astype(np.int32), dst=dst.astype(np.int32),
              weight=np.full(256, 0.5, dtype=np.float32), n_pad=n, m_real=256)
    with pytest.raises(ValueError, match="padding edge"):
        T.build_partition(g, make_x_vector(8), 2, device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        T.lane_fill_rate(g, make_x_vector(40), lane_width=32, device="cpu")
