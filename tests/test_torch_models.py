"""The port's graph generators and model zoo give the reference's arrays
byte for byte."""
import numpy as np
import pytest

from repro import diffusion as rdiff
from repro import graphs as rgraphs
from repro_torch import diffusion as tdiff
from repro_torch import graphs as tgraphs
from repro_torch.core.sampling import INTERVAL, REMIX

GRAPHS = [("rmat", 8, "w1"), ("rmat", 9, "u01"), ("rmat-skew", 8, "n005"),
          ("er", 300, "w01"), ("ba", 200, "w1")]


def _pair(kind, size, setting):
    if kind == "rmat":
        return (rgraphs.rmat_graph(size, seed=2, setting=setting),
                tgraphs.rmat_graph(size, seed=2, setting=setting))
    if kind == "rmat-skew":
        kw = dict(edge_factor=8, a=0.65, b=0.15, c=0.15, setting=setting, seed=1,
                  permute_ids=False)
        return rgraphs.rmat_graph(size, **kw), tgraphs.rmat_graph(size, **kw)
    if kind == "er":
        return (rgraphs.erdos_renyi_graph(size, seed=4, setting=setting),
                tgraphs.erdos_renyi_graph(size, seed=4, setting=setting))
    return (rgraphs.barabasi_albert_graph(size, seed=5, setting=setting),
            tgraphs.barabasi_albert_graph(size, seed=5, setting=setting))


def _same_graph(a, b):
    assert (a.n, a.n_pad, a.m_real) == (b.n, b.n_pad, b.m_real)
    for f in ("src", "dst", "weight"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind,size,setting", GRAPHS)
def test_graphs_equal(kind, size, setting):
    a, b = _pair(kind, size, setting)
    _same_graph(a, b)
    _same_graph(a.sorted_by_dst(), b.sorted_by_dst())


@pytest.mark.parametrize("model", ["wc", "ic", "ic:0.3", "lt", "dic", "dic:2.5"])
@pytest.mark.parametrize("kind,size,setting", GRAPHS[:3])
def test_edge_params_byte_equal(model, kind, size, setting):
    a, b = _pair(kind, size, setting)
    a, b = a.sorted_by_dst(), b.sorted_by_dst()
    for seed in (0, 9):
        want = rdiff.resolve(model).edge_params(a, seed=seed)
        got = tdiff.resolve(model).edge_params(b, seed=seed)
        for f in ("h", "lo", "thr"):
            x, y = getattr(want, f), getattr(got, f)
            assert x.dtype == y.dtype == np.uint32
            assert x.tobytes() == y.tobytes(), (model, f)
    assert (got.thr[b.m_real:] == 0).all()


def test_predicate_variants():
    assert tdiff.resolve("lt").variant == REMIX
    for spec in ("wc", "ic:0.2", "dic:1.0"):
        assert tdiff.resolve(spec).variant == INTERVAL


@pytest.mark.parametrize("spec,err", [("wc:0.5", ValueError), ("nope", KeyError),
                                      ("ic:2", ValueError), ("", TypeError)])
def test_resolve_rejects(spec, err):
    with pytest.raises(err):
        tdiff.resolve(spec)
