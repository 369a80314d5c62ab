"""The dst sort on the job's device (``Graph.sorted_by_dst(device)``): a
stable torch sort of the int64 key ``dst * n_pad + src`` gives the host's
``np.lexsort`` graph byte for byte, and the single path and the serial ring
give the same seeds, gains, scores, rebuilds and sweep counts with it as
with the host sort. The sort spans say where the sort ran and what it
copied. The CUDA cases run on the card and skip elsewhere."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_threads import two_torch_threads  # noqa: F401  (autouse)
from repro_torch.core import difuser
from repro_torch.graphs import rmat_graph
from repro_torch.graphs.structs import Graph
from repro_torch.obs import trace
from repro_torch.partition import serial
from repro_torch.runtime import RunSpec, get_backend

K = 4


def _skewed(seed: int, n: int = 3000, m: int = 40000) -> Graph:
    """Power-law destinations, so long runs of equal ``dst`` sort by ``src``."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = (rng.zipf(1.6, m) - 1) % n
    return Graph.from_edges(n, src, dst, rng.random(m).astype(np.float32))


def _repeats() -> Graph:
    """Repeated (u, v) pairs with distinct weights, kept apart: only a stable
    sort keeps their weights in the input's order."""
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 12, 5000), rng.integers(0, 12, 5000)
    return Graph.from_edges(12, src, dst, rng.random(5000).astype(np.float32), dedup=False)


def _wide_ids() -> Graph:
    """Ids near 2^30, whose key needs the int64's upper half."""
    rng = np.random.default_rng(5)
    n = 2 ** 30 + 3
    src = np.concatenate([n - 1 - rng.integers(0, 50, 600), rng.integers(0, n, 200)])
    dst = np.concatenate([n - 1 - rng.integers(0, 50, 600), rng.integers(0, n, 200)])
    return Graph.from_edges(n, src, dst, dedup=False)


GRAPHS = {
    "skewed0": lambda: _skewed(0),
    "skewed1": lambda: _skewed(1, n=257, m=9000),
    "repeats": _repeats,
    "empty": lambda: Graph.from_edges(6, np.zeros(0, int), np.zeros(0, int)),
    "one_edge": lambda: Graph.from_edges(6, [4], [1], [0.25]),
    "wide_ids": _wide_ids,
}
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device(name)


def _assert_same_graph(got: Graph, want: Graph) -> None:
    assert (got.n, got.n_pad, got.m_real) == (want.n, want.n_pad, want.m_real)
    for field in ("src", "dst", "weight"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_device_sort_is_lexsort_byte_for_byte(case, device):
    dev = _device(device)
    g = GRAPHS[case]()
    want = g.sorted_by_dst()
    got = g.sorted_by_dst(dev)
    _assert_same_graph(got, want)
    # the padding stays at the end, and sorting again changes nothing
    r, sentinel = g.m_real, g.n_pad - 1
    assert (got.src[r:] == sentinel).all() and (got.dst[r:] == sentinel).all()
    assert (got.weight[r:] == 0).all()
    _assert_same_graph(got.sorted_by_dst(dev), want)
    # the input is left as it was
    _assert_same_graph(g, GRAPHS[case]())


def test_cases_reach_what_they_are_named_for():
    rep = GRAPHS["repeats"]()
    keys = rep.src[:rep.m_real].astype(np.int64) * rep.n_pad + rep.dst[:rep.m_real]
    assert np.unique(keys).size < keys.size // 10
    wide = GRAPHS["wide_ids"]()
    assert int(wide.dst[:wide.m_real].max()) * wide.n_pad >= 2 ** 59
    assert GRAPHS["empty"]().m == 0 and GRAPHS["one_edge"]().m_real == 1
    sk = GRAPHS["skewed1"]()
    assert sk.m > sk.m_real    # padding to keep at the end


@pytest.mark.parametrize("device,expect", [("cpu", 0), ("cuda", 24), ("cuda:0", 24)])
def test_sort_bytes_are_the_edges_there_and_back(device, expect):
    """Three 4-byte arrays up and the int32 [3, m] block back, padding
    included; on the CPU nothing crosses."""
    g = GRAPHS["skewed1"]()
    assert g.dst_sort_bytes(device) == expect * g.m


def test_device_sort_refuses_other_dtypes():
    g = GRAPHS["one_edge"]()
    wide = dataclasses.replace(g, src=g.src.astype(np.int64))
    with pytest.raises(TypeError, match="int32"):
        wide.sorted_by_dst("cpu")
    assert wide.sorted_by_dst().src.dtype == np.int64


@pytest.mark.cuda
def test_device_sort_frees_its_temporaries_on_cuda():
    dev = _device("cuda")
    g = _skewed(2, n=20000, m=300000)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    got = g.sorted_by_dst(dev)
    assert torch.cuda.memory_allocated(dev) == before
    _assert_same_graph(got, g.sorted_by_dst())


def _host_sorted(monkeypatch):
    """``Graph.sorted_by_dst`` as the host's ``lexsort``, whatever device
    the caller passes."""
    host = Graph.sorted_by_dst
    monkeypatch.setattr(Graph, "sorted_by_dst", lambda self, device=None: host(self))


def _same_run(got, want):
    np.testing.assert_array_equal(got.seeds, want.seeds)
    np.testing.assert_array_equal(got.est_gains, want.est_gains)
    np.testing.assert_array_equal(got.scores, want.scores)
    np.testing.assert_array_equal(got.rebuilds, want.rebuilds)
    assert got.propagate_iters == want.propagate_iters
    for key in ("cascade_sweeps", "rebuild_sweeps"):
        assert got.stats[key] == want.stats[key], key


def _run(path: str, model: str):
    g = rmat_graph(7, seed=5, setting="w1")
    cfg = difuser.DiFuserConfig(num_registers=32, seed=1, model=model)
    if path == "single":
        return difuser.find_seeds(g, K, cfg, device="cpu")
    res, _ = serial.find_seeds_ring_serial(g, K, cfg, strategy="degree", device="cpu")
    return res


@pytest.mark.parametrize("model", ["wc", "lt"])
@pytest.mark.parametrize("path", ["single", "serial"])
def test_seeds_equal_the_host_sorted_run(path, model, monkeypatch):
    got = _run(path, model)
    with monkeypatch.context() as mp:
        _host_sorted(mp)
        want = _run(path, model)
    _same_run(got, want)


def test_warm_rounds_and_builds_sort_on_the_device(monkeypatch):
    """``build_sketch_matrix``, ``find_seeds_warm`` and the serial backend's
    ``build_matrix`` hand their device to the sort, and agree with the
    single path's cold run."""
    seen = []
    sort = Graph.sorted_by_dst
    monkeypatch.setattr(Graph, "sorted_by_dst",
                        lambda self, device=None: seen.append(device) or sort(self, device))
    g = rmat_graph(6, seed=2, setting="w1")
    cfg = difuser.DiFuserConfig(num_registers=32, seed=4)
    m, iters, x = difuser.build_sketch_matrix(g, cfg, device="cpu")
    warm = difuser.find_seeds_warm(g, K, cfg, matrix=m, x=x, device="cpu")
    ring, _ = get_backend("serial").build_matrix(
        g, RunSpec(num_registers=32, seed=4, mu_v=2, mu_s=1), x, device="cpu")
    assert [d.type for d in seen] == ["cpu", "cpu", "cpu"]
    cold = difuser.find_seeds(g, K, cfg, device="cpu")
    np.testing.assert_array_equal(warm.seeds, cold.seeds)
    assert iters == cold.propagate_iters
    np.testing.assert_array_equal(np.asarray(ring), np.asarray(m))


@pytest.mark.parametrize("path", ["single", "serial"])
def test_sort_span_names_its_device_and_bytes(path):
    rec = trace.get_recorder()
    rec.start()
    try:
        _run(path, "wc")
        (ev,) = [ev for ev in rec.events() if ev["name"] == f"{path}.sort_by_dst"]
    finally:
        rec.stop()
        rec.clear()
    assert ev["attrs"]["on"] == "cpu" and ev["attrs"]["bytes"] == 0
