"""The port's hashes and predicates against the reference's
``repro.core.sampling``, on random uint32 inputs with wraparound."""
import numpy as np
import pytest
import torch

from repro.core import sampling as ref
from repro_torch.core import sampling as port

EDGE = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _u32(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([EDGE, v])


def _t(a):
    return port.as_u32(torch.from_numpy(a.view(np.int32)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix32(seed):
    x = _u32(4096, seed)
    np.testing.assert_array_equal(port.mix32(x), ref.mix32(x))
    np.testing.assert_array_equal(port.t_mix32(_t(x)).numpy().astype(np.uint32), ref.mix32(x))


@pytest.mark.parametrize("seed", [0, 7, 0xFFFFFFFF])
def test_register_hash(seed):
    u = _u32(300, 3)[:, None]
    j = _u32(40, 4)[None, :]
    want = ref.register_hash(u, j, seed=seed)
    np.testing.assert_array_equal(port.register_hash(u, j, seed=seed), want)
    got = port.t_register_hash(_t(u.ravel())[:, None], _t(j.ravel())[None, :], seed)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("seed", [0, 5, 0x7FFFFFFF])
def test_edge_and_vertex_hash(seed):
    a, b = _u32(2000, 5), _u32(2000, 6)
    np.testing.assert_array_equal(port.edge_hash(a, b, seed=seed),
                                  ref.edge_hash(a, b, seed=seed))
    np.testing.assert_array_equal(port.vertex_hash(a, seed=seed),
                                  ref.vertex_hash(a, seed=seed))


@pytest.mark.parametrize("which", ["fused", "remix"])
def test_predicates(which):
    h, lo, thr, x = (_u32(5000, s) for s in (10, 11, 12, 13))
    thr[::3] >>= 3
    thr[::11] = 0
    lo[::5] = 0
    want = {"fused": ref.fused_predicate, "remix": ref.remix_interval_predicate}[which](
        h, lo, thr, x)
    fn = port.PREDICATES[port.INTERVAL if which == "fused" else port.REMIX]
    got = fn(_t(h), _t(lo), _t(thr), _t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size


def test_clz32():
    x = np.concatenate([_u32(3000, 20), (np.uint32(1) << np.arange(32, dtype=np.uint32))])
    np.testing.assert_array_equal(port.t_clz32(_t(x)).numpy(), ref.clz32(x))


@pytest.mark.parametrize("w", [0.0, 1.0, np.nextafter(np.float32(1), np.float32(0)),
                               np.nextafter(1.0, 0.0), 0.5, 1e-10, 0.1])
def test_weight_to_threshold(w):
    for arr in (np.float32(w), np.array([w, 0.25], np.float64), np.array([w, 0.25], np.float32)):
        np.testing.assert_array_equal(port.weight_to_threshold(arr),
                                      ref.weight_to_threshold(arr))
    assert port.weight_to_threshold(np.float32(0.0)) == 0


@pytest.mark.parametrize("n,seed", [(64, 0), (1000, 3)])
def test_make_x_vector(n, seed):
    np.testing.assert_array_equal(port.make_x_vector(n, seed), ref.make_x_vector(n, seed))
