"""The port's graph-delta repair (``repro_torch.service.delta``) against the
reference's ``apply_delta``, on the CPU: the insertion repair byte-equal to
a pristine rebuild and to the reference's repair, with the same sweeps and
banks touched; removal staleness and its lazy rebuild; the threshold
rebuild; lt always rebuilding; the top-k memo dropped by a delta; and the
plan shards a delta touches. The shard-restricted repair has its own file,
``test_torch_shard_repair.py``."""
import numpy as np
import pytest
import torch

from repro.core import difuser as R_difuser
from repro.graphs import rmat_graph as ref_rmat
from repro.graphs.structs import GraphDelta as RDelta
from repro.partition import plan_partition as r_plan
from repro.service import InfluenceEngine as REngine
from repro.service import SketchStore as RStore
from repro.service import TopKSeeds as RTopK
from repro.service import apply_delta as r_apply
from repro_torch.core import difuser as T_difuser
from repro_torch.graphs import GraphDelta
from repro_torch.graphs import rmat_graph as port_rmat
from repro_torch.kernels import counters
from repro_torch.partition import plan_partition as t_plan
from repro_torch.service import InfluenceEngine, SketchStore, TopKSeeds, apply_delta


def _setup(num_regs=64, banks=1, model="wc", scale=9):
    """Reference and port stores over one graph: (rg, r_store, rk, tg,
    t_store, tk)."""
    rg = ref_rmat(scale, edge_factor=8, seed=21, setting="w1")
    tg = port_rmat(scale, edge_factor=8, seed=21, setting="w1")
    rc = R_difuser.DiFuserConfig(num_registers=num_regs, seed=2, model=model)
    tc = T_difuser.DiFuserConfig(num_registers=num_regs, seed=2, model=model)
    r_store, t_store = RStore(num_banks=banks), SketchStore(num_banks=banks, device="cpu")
    return (rg, r_store, r_store.get_or_build(rg, rc).key,
            tg, t_store, t_store.get_or_build(tg, tc).key)


def _bytes(m) -> bytes:
    return (m.numpy() if isinstance(m, torch.Tensor) else np.asarray(m)).tobytes()


def _insertions(n, count, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, count), rng.integers(0, n, count)


def _removals(g, count, seed=8):
    idx = np.random.default_rng(seed).choice(g.m_real, count, replace=False)
    return g.src[idx], g.dst[idx]


def _pristine(t_store, tk, banks):
    """A fresh build on the entry's current graph with its x."""
    e = t_store.entry(tk)
    return SketchStore(num_banks=banks, device="cpu").get_or_build(e.graph, e.cfg, x=e.x)


def _same_report(got, want):
    for field in ("added", "removed", "rebuilt", "stale", "repair_sweeps", "banks_touched",
                  "plan_shards_touched"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.staleness_frac == pytest.approx(want.staleness_frac, rel=1e-12)


@pytest.mark.parametrize("num_regs,banks,model", [
    (64, 1, "wc"), (64, 2, "wc"), (38, 2, "ic:0.1"), (64, 2, "dic:1.0")])
def test_insertion_repair_matches_rebuild_and_reference(num_regs, banks, model):
    rg, r_store, rk, tg, t_store, tk = _setup(num_regs, banks, model)
    add = _insertions(tg.n, 40)
    want = r_apply(r_store, rk, RDelta.make(add=add))
    counters.reset()
    got = apply_delta(t_store, tk, GraphDelta.make(add=add))
    _same_report(got, want)
    assert not got.rebuilt and got.banks_touched >= 1 and got.repair_sweeps >= 2
    assert "sketch_fill" not in counters.PLAIN_CALLS   # repaired, not rebuilt
    entry = t_store.entry(tk)
    assert entry.version == 1 and not entry.stale
    assert _bytes(entry.matrix) == _bytes(r_store.entry(rk).matrix)
    assert _bytes(entry.matrix) == _bytes(_pristine(t_store, tk, banks).matrix)
    np.testing.assert_array_equal(entry.graph.src, r_store.entry(rk).graph.src)
    assert entry.device_edges().num_edges == entry.graph.m


def test_insertions_of_self_loops_touch_nothing():
    rg, r_store, rk, tg, t_store, tk = _setup()
    loops = (np.arange(5), np.arange(5))
    want = r_apply(r_store, rk, RDelta.make(add=loops))
    got = apply_delta(t_store, tk, GraphDelta.make(add=loops))
    _same_report(got, want)
    assert got.repair_sweeps == got.banks_touched == 0


def test_removal_staleness_then_lazy_rebuild():
    rg, r_store, rk, tg, t_store, tk = _setup()
    rem = _removals(tg.sorted_by_dst(), 20)
    want = r_apply(r_store, rk, RDelta.make(remove=rem))
    got = apply_delta(t_store, tk, GraphDelta.make(remove=rem))
    _same_report(got, want)
    assert got.stale and not got.rebuilt and got.removed == 20
    entry = t_store.entry(tk)
    stale_matrix = _bytes(entry.matrix)
    engine = InfluenceEngine(t_store)
    warm = engine(tk, TopKSeeds(5)).value
    assert not entry.stale and entry.rebuilds == 1 and entry.staleness_frac == 0.0
    assert _bytes(entry.matrix) != stale_matrix
    assert _bytes(entry.matrix) == _bytes(_pristine(t_store, tk, 1).matrix)
    ref = REngine(r_store)(rk, RTopK(5)).value
    np.testing.assert_array_equal(warm.seeds, ref.seeds)
    cold = T_difuser.find_seeds(entry.graph, 5, entry.cfg, x=entry.x, device="cpu")
    np.testing.assert_array_equal(warm.seeds, cold.seeds)


def test_removal_threshold_rebuilds():
    rg, r_store, rk, tg, t_store, tk = _setup()
    rem = _removals(tg.sorted_by_dst(), 300)
    add = _insertions(tg.n, 10)
    want = r_apply(r_store, rk, RDelta.make(add=add, remove=rem), staleness_threshold=0.05)
    got = apply_delta(t_store, tk, GraphDelta.make(add=add, remove=rem),
                      staleness_threshold=0.05)
    _same_report(got, want)
    assert got.rebuilt and not got.stale and got.staleness_frac == 0.0
    assert _bytes(t_store.entry(tk).matrix) == _bytes(r_store.entry(rk).matrix)


@pytest.mark.parametrize("kind", ["add", "remove"])
def test_lt_always_rebuilds(kind):
    rg, r_store, rk, tg, t_store, tk = _setup(model="lt", scale=8)
    kw = {"add": _insertions(tg.n, 8)} if kind == "add" else \
        {"remove": _removals(tg.sorted_by_dst(), 3)}
    want = r_apply(r_store, rk, RDelta.make(**kw))
    got = apply_delta(t_store, tk, GraphDelta.make(**kw))
    _same_report(got, want)
    assert got.rebuilt and not got.stale and got.repair_sweeps == 0
    assert _bytes(t_store.entry(tk).matrix) == _bytes(r_store.entry(rk).matrix)
    assert _bytes(t_store.entry(tk).matrix) == _bytes(_pristine(t_store, tk, 1).matrix)


def test_topk_memo_dropped_by_delta():
    rg, r_store, rk, tg, t_store, tk = _setup(num_regs=32, scale=8)
    engine = InfluenceEngine(t_store)
    first = engine(tk, TopKSeeds(4))
    assert not first.cache_hit and engine(tk, TopKSeeds(4)).cache_hit
    apply_delta(t_store, tk, GraphDelta.make(add=_insertions(tg.n, 30)))
    after = engine(tk, TopKSeeds(4))
    assert not after.cache_hit and after.backend == "single:host"
    entry = t_store.entry(tk)
    cold = T_difuser.find_seeds(entry.graph, 4, entry.cfg, x=entry.x, device="cpu")
    np.testing.assert_array_equal(after.value.seeds, cold.seeds)
    assert engine(tk, TopKSeeds(4)).cache_hit


def test_plan_shards_touched_match_reference():
    rg, r_store, rk, tg, t_store, tk = _setup()
    r_store.attach_plan(rk, r_plan(r_store.entry(rk).graph, 4, strategy="degree", seed=2))
    t_store.attach_plan(tk, t_plan(t_store.entry(tk).graph, 4, strategy="degree", seed=2))
    add = (np.array([3, 9]), np.array([40, 41]))
    want = r_apply(r_store, rk, RDelta.make(add=add))
    got = apply_delta(t_store, tk, GraphDelta.make(add=add))
    _same_report(got, want)
    assert got.plan_shards_touched
    assert _bytes(t_store.entry(tk).planned_matrix()) == _bytes(
        r_store.entry(rk).planned_matrix())
