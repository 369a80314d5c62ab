"""The port's shard-restricted delta repair and the backends' inner hooks
against the reference's, on the CPU.

* ``repair_plan_shards`` (``partition/serial.py``) against the reference's on
  the same post-delta graph, plan and plan-order matrix: the repaired matrix
  byte for byte, equal sweeps and shards swept, on 2 and 3 vertex shards,
  1 and 2 banks, wc and ic;
* ``apply_delta(…, backend="serial"|"auto")`` with a plan attached: the
  matrix byte-equal to the reference's and to the per-bank repair, with
  equal repair sweeps, plan shards touched and shards swept; a localized
  delta sweeps its own shard alone;
* the reference's two-community cases (``tests/test_runtime.py``): only the
  dirtied shard swept, a bridge edge spreading to both, the fallback without
  a plan, and the session routing through its backend;
* the ``fixpoint``/``cascade``/``repair_plan_shards`` hooks of both backends,
  and ``apply_delta_async(…, backend="serial")``.
"""
import numpy as np
import pytest
import torch

from repro.core import difuser as R_difuser
from repro.graphs import rmat_graph as ref_rmat
from repro.graphs.structs import Graph as RGraph
from repro.graphs.structs import GraphDelta as RDelta
from repro.partition import plan_partition as r_plan
from repro.partition import serial as R_serial
from repro.runtime import InfluenceSession as RSession
from repro.runtime import RunSpec as RSpec
from repro.runtime import get_backend as r_backend
from repro.service import SketchStore as RStore
from repro.service import apply_delta as r_apply
from repro_torch.core import difuser as T_difuser
from repro_torch.core.sketch import VISITED
from repro_torch.graphs import GraphDelta
from repro_torch.graphs import rmat_graph as port_rmat
from repro_torch.graphs.structs import Graph
from repro_torch.kernels import counters
from repro_torch.partition import plan_partition as t_plan
from repro_torch.partition import serial as T_serial
from repro_torch.runtime import InfluenceSession, RunSpec, get_backend, run
from repro_torch.service import AsyncInfluenceEngine, SketchStore, apply_delta

WAIT = 60      # seconds: the longest a future is waited for


def _bytes(m) -> bytes:
    return (m.numpy() if isinstance(m, torch.Tensor) else np.asarray(m)).tobytes()


def _rmat_pair(scale=8):
    return (ref_rmat(scale, edge_factor=8, seed=21, setting="w1"),
            port_rmat(scale, edge_factor=8, seed=21, setting="w1"))


def _insertions(n, count, seed=7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, count), rng.integers(0, n, count)


def _stores(rg, tg, *, num_regs=64, banks=1, model="wc", mu_v=2, strategy="block"):
    """Reference and port stores over one graph, each with a plan of
    ``mu_v`` shards attached: (r_store, rk, t_store, tk)."""
    rc = R_difuser.DiFuserConfig(num_registers=num_regs, seed=2, model=model, impl="ref")
    tc = T_difuser.DiFuserConfig(num_registers=num_regs, seed=2, model=model)
    r_store, t_store = RStore(num_banks=banks), SketchStore(num_banks=banks, device="cpu")
    rk, tk = r_store.get_or_build(rg, rc).key, t_store.get_or_build(tg, tc).key
    if mu_v:
        re_, te = r_store.entry(rk), t_store.entry(tk)
        r_store.attach_plan(rk, r_plan(re_.graph, mu_v, strategy=strategy, x=re_.x, seed=2))
        t_store.attach_plan(tk, t_plan(te.graph, mu_v, strategy=strategy, x=te.x, seed=2,
                                       device="cpu"))
    return r_store, rk, t_store, tk


# -- repair_plan_shards against the reference's ----------------------------------------

@pytest.mark.parametrize("mu_v", [2, 3])
@pytest.mark.parametrize("banks", [1, 2])
@pytest.mark.parametrize("model", ["wc", "ic:0.1"])
def test_repair_plan_shards_matches_reference(mu_v, banks, model):
    rg, tg = _rmat_pair()
    r_store, rk, t_store, tk = _stores(rg, tg, banks=banks, model=model, mu_v=mu_v,
                                       strategy="degree")
    re_, te = r_store.entry(rk), t_store.entry(tk)
    assert _bytes(te.planned_matrix()) == _bytes(re_.planned_matrix())
    add = _insertions(tg.n, 30)
    r_new = re_.graph.apply_delta(RDelta.make(add=add)).sorted_by_dst()
    t_new = te.graph.apply_delta(GraphDelta.make(add=add)).sorted_by_dst()
    touched = tuple(np.unique(te.plan.owner_of(np.concatenate(add))).tolist())
    want, w_sweeps, w_swept = R_serial.repair_plan_shards(
        r_new, re_.cfg, re_.x, np.asarray(re_.planned_matrix()), re_.plan, touched)
    before = _bytes(te.planned_matrix())
    counters.reset()
    got, sweeps, swept = T_serial.repair_plan_shards(
        t_new, te.cfg, te.x, te.planned_matrix(), te.plan, touched)
    assert _bytes(got) == _bytes(want)
    assert (sweeps, swept) == (w_sweeps, w_swept)
    assert sweeps >= 2 and set(swept) >= set(touched)
    assert _bytes(te.planned_matrix()) == before         # the input is not written
    assert counters.PLAIN_CALLS["bucket_propagate"] > 0 and not counters.LAUNCHES
    assert "sketch_fill" not in counters.PLAIN_CALLS     # a warm start, no fill
    # and the result is the post-delta build's fixpoint
    fresh = SketchStore(num_banks=banks, device="cpu").get_or_build(t_new, te.cfg, x=te.x)
    fresh.plan = te.plan
    assert _bytes(got) == _bytes(fresh.planned_matrix())


@pytest.mark.parametrize("backend", ["auto", "serial"])
@pytest.mark.parametrize("banks", [1, 2])
def test_apply_delta_shard_repair_matches_reference(backend, banks):
    """The requests that raised NotImplementedError before the port had the
    repair: byte-equal to the reference's and to the per-bank repair."""
    rg, tg = _rmat_pair(9)
    r_store, rk, t_store, tk = _stores(rg, tg, banks=banks, mu_v=4, strategy="degree")
    _, _, p_store, pk = _stores(rg, tg, banks=banks, mu_v=4, strategy="degree")
    add = _insertions(tg.n, 40)
    want = r_apply(r_store, rk, RDelta.make(add=add), backend=backend)
    got = apply_delta(t_store, tk, GraphDelta.make(add=add), backend=backend)
    per_bank = apply_delta(p_store, pk, GraphDelta.make(add=add))
    assert got.repair_backend == want.repair_backend == "serial"
    assert per_bank.repair_backend == "single" and per_bank.shards_swept == ()
    for field in ("added", "rebuilt", "stale", "repair_sweeps", "banks_touched",
                  "plan_shards_touched", "shards_swept"):
        assert getattr(got, field) == getattr(want, field), field
    entry = t_store.entry(tk)
    assert entry.version == r_store.entry(rk).version and not got.rebuilt
    assert got.repair_sweeps > 0
    assert _bytes(entry.matrix) == _bytes(r_store.entry(rk).matrix)
    assert _bytes(entry.matrix) == _bytes(p_store.entry(pk).matrix)
    # the plan-order cache is the repair's output and equals a fresh permutation
    cached = entry.planned_matrix()
    entry._planned_cache = None
    assert _bytes(cached) == _bytes(entry.planned_matrix())
    assert entry.device_edges().num_edges == entry.graph.m


def test_localized_delta_sweeps_its_shard_alone():
    rg, tg = _rmat_pair(9)
    r_store, rk, t_store, tk = _stores(rg, tg, mu_v=4)
    plan = t_store.entry(tk).plan
    in_0 = np.flatnonzero(plan.owner_of(np.arange(tg.n)) == 0)
    rng = np.random.default_rng(3)
    add = (rng.choice(in_0, 30), rng.choice(in_0, 30))
    want = r_apply(r_store, rk, RDelta.make(add=add), backend="serial")
    got = apply_delta(t_store, tk, GraphDelta.make(add=add), backend="serial")
    assert got.plan_shards_touched == want.plan_shards_touched == (0,)
    assert got.shards_swept == want.shards_swept
    assert got.repair_sweeps == want.repair_sweeps
    assert _bytes(t_store.entry(tk).matrix) == _bytes(r_store.entry(rk).matrix)


# -- the reference's two-community cases ------------------------------------------------

_CUT = 28
_N = 48


def _two_community(cls, seed: int = 4):
    """Two disconnected communities split at the block plan's shard boundary:
    ids [0, 28) in shard 0, [28, 48) in shard 1."""
    rng = np.random.default_rng(seed)
    m_half = _N * 4
    src = np.concatenate([rng.integers(0, _CUT, m_half), rng.integers(_CUT, _N, m_half)])
    dst = np.concatenate([rng.integers(0, _CUT, m_half), rng.integers(_CUT, _N, m_half)])
    g = cls.from_edges(_N, src, dst, np.full(src.shape[0], 0.35, dtype=np.float32))
    assert g.n_pad == 2 * _CUT, "padding layout moved; realign _CUT"
    return g


def _community_stores():
    return _stores(_two_community(RGraph), _two_community(Graph), num_regs=128, mu_v=2)


@pytest.mark.parametrize("add,touched", [
    (([_CUT + 1, _CUT + 3], [_CUT + 5, _CUT + 2]), (1,)),    # inside community B
    (([1], [_CUT + 7]), (0, 1)),                             # an A -> B bridge
])
def test_two_community_repair_sweeps_what_it_must(add, touched):
    r_store, rk, t_store, tk = _community_stores()
    _, _, p_store, pk = _community_stores()
    want = r_apply(r_store, rk, RDelta.make(add=add, default_weight=0.9), backend="serial")
    got = apply_delta(t_store, tk, GraphDelta.make(add=add, default_weight=0.9),
                      backend="serial")
    apply_delta(p_store, pk, GraphDelta.make(add=add, default_weight=0.9))
    assert got.repair_backend == "serial" and got.plan_shards_touched == touched
    assert got.shards_swept == want.shards_swept and got.repair_sweeps == want.repair_sweeps
    if touched == (1,):
        assert got.shards_swept == (1,)      # disconnected: it cannot leave shard 1
    assert set(got.shards_swept) >= set(touched) and not got.rebuilt
    entry = t_store.entry(tk)
    rebuilt = SketchStore(device="cpu").get_or_build(entry.graph, entry.cfg)
    assert _bytes(entry.matrix) == _bytes(rebuilt.matrix)
    assert _bytes(entry.matrix) == _bytes(p_store.entry(pk).matrix)
    assert _bytes(entry.matrix) == _bytes(r_store.entry(rk).matrix)


def test_repair_without_plan_falls_back_to_the_per_bank_repair():
    r_store, rk, t_store, tk = _stores(_two_community(RGraph), _two_community(Graph),
                                       num_regs=128, mu_v=0)
    want = r_apply(r_store, rk, RDelta.make(add=([2], [5])), backend="serial")
    got = apply_delta(t_store, tk, GraphDelta.make(add=([2], [5])), backend="serial")
    assert got.repair_backend == want.repair_backend == "single"
    assert got.shards_swept == () and got.repair_sweeps == want.repair_sweeps
    entry = t_store.entry(tk)
    assert _bytes(entry.matrix) == _bytes(r_store.entry(rk).matrix)
    assert _bytes(entry.matrix) == _bytes(
        SketchStore(device="cpu").get_or_build(entry.graph, entry.cfg).matrix)


def test_session_apply_delta_routes_through_its_backend():
    spec = RunSpec(num_registers=128, seed=3, backend="serial", mu_v=2, mu_s=1)
    sess = InfluenceSession(_two_community(Graph), spec, device="cpu")
    r_sess = RSession(_two_community(RGraph), RSpec(num_registers=128, seed=3,
                                                    backend="serial", mu_v=2, mu_s=1))
    for s, plan_fn, kw in ((sess, t_plan, {"device": "cpu"}), (r_sess, r_plan, {})):
        e = s.entry()
        s.store.attach_plan(e.key, plan_fn(e.graph, 2, mu_s=1, strategy="block", x=e.x,
                                           seed=3, **kw))
    rep = sess.apply_delta(GraphDelta.make(add=([_CUT + 1], [_CUT + 9])))
    r_rep = r_sess.apply_delta(RDelta.make(add=([_CUT + 1], [_CUT + 9])))
    assert rep.repair_backend == r_rep.repair_backend == "serial"
    assert rep.plan_shards_touched == (1,) and rep.shards_swept == r_rep.shards_swept
    assert _bytes(sess.entry().matrix) == _bytes(r_sess.entry().matrix)
    cold = run(sess.graph, 3, RunSpec(num_registers=128, seed=3, backend="single"),
               device="cpu").result
    np.testing.assert_array_equal(sess.find_seeds_warm(3).seeds, cold.seeds)


# -- the backends' hooks --------------------------------------------------------------

def test_backend_hooks_fixpoint_and_cascade():
    rg = ref_rmat(7, edge_factor=6, seed=9, setting="w1")
    tg = port_rmat(7, edge_factor=6, seed=9, setting="w1")
    r_spec, spec = RSpec(num_registers=128, seed=3), RunSpec(num_registers=128, seed=3)
    rgn, rxn = R_difuser.normalize_inputs(rg, r_spec.difuser_config())
    gn, xn = T_difuser.normalize_inputs(tg, spec.difuser_config())
    single, serial = get_backend("single"), get_backend("serial")
    r_single = r_backend("single")
    m, _ = single.build_matrix(gn, spec, xn, normalized=True, device="cpu")
    r_m, _ = r_single.build_matrix(rgn, r_spec, rxn, normalized=True)
    assert _bytes(m) == _bytes(r_m)
    assert single.capabilities().shard_repair is False
    assert serial.capabilities().shard_repair is True

    # a propagated matrix is at its fixpoint: both hooks give it back
    before = _bytes(m)
    m_fix, _ = single.fixpoint(m, gn, spec, xn)
    assert _bytes(m_fix) == before
    m_fix2, it2 = serial.fixpoint(m, gn, spec.with_(mu_v=2, mu_s=2), xn)
    assert _bytes(m_fix2) == before and it2 == 1 and _bytes(m) == before

    # from the old matrix, the post-delta graph's fixpoint: equal to the
    # reference's hook and to a rebuild, on both backends
    add = _insertions(tg.n, 25)
    rg2, rx2 = R_difuser.normalize_inputs(rg.apply_delta(RDelta.make(add=add)),
                                          r_spec.difuser_config())
    g2, x2 = T_difuser.normalize_inputs(tg.apply_delta(GraphDelta.make(add=add)),
                                        spec.difuser_config())
    r_fix, r_it = r_single.fixpoint(r_m, rg2, r_spec, rx2)
    got, it = single.fixpoint(m, g2, spec, x2)
    assert _bytes(got) == _bytes(r_fix) and it == int(r_it)
    got2, _ = serial.fixpoint(m, g2, spec.with_(mu_v=3, mu_s=2), x2)
    rebuilt, _ = single.build_matrix(g2, spec, x2, normalized=True, device="cpu")
    assert _bytes(got2) == _bytes(rebuilt) == _bytes(got)

    # cascade: the committed seed's row floods, as the reference's hook does
    s = int(run(tg, 1, spec, device="cpu").result.seeds[0])
    m_casc, c_it = single.cascade(m, s, gn, spec, xn)
    r_casc, r_c_it = r_single.cascade(r_m, s, rgn, r_spec, rxn)
    assert (m_casc[s] == VISITED).all() and _bytes(m) == before
    assert _bytes(m_casc) == _bytes(r_casc) and c_it == int(r_c_it)
    with pytest.raises(NotImplementedError, match="serial"):
        serial.cascade(m, s, gn, spec, xn)
    with pytest.raises(NotImplementedError, match="shard_repair"):
        single.repair_plan_shards(gn, spec, xn, m, None, (0,))


def test_ring_state_warm_start_copies_and_refuses_refill():
    tg = port_rmat(7, edge_factor=6, seed=9, setting="w1")
    cfg = T_difuser.DiFuserConfig(num_registers=64, seed=3)
    g, x = T_difuser.normalize_inputs(tg, cfg)
    from repro_torch.partition import build_partition_2d

    part = build_partition_2d(g, x, 2, 1, seed=3, device="cpu")
    grid = torch.zeros((2, 1, part.n_loc, part.j_loc), dtype=torch.int8)
    st = T_serial._RingState(part, g, cfg, matrix=grid)
    assert st.fresh is None and st.m.data_ptr() != grid.data_ptr()
    st.sweep_propagate_restricted({0, 1})
    assert not grid.any()                   # the caller's grid was not written
    with pytest.raises(RuntimeError, match="refill"):
        st.refill()
    with pytest.raises(ValueError, match="grid"):
        T_serial._RingState(part, g, cfg, matrix=grid[:, :, 1:])


def test_apply_delta_async_takes_the_serial_repair():
    """``apply_delta_async(…, backend="serial")`` passes the backend through:
    the shadow is repaired shard by shard, byte-equal to the sync repair,
    and version N's banks keep their bytes."""
    _, tg = _rmat_pair(8)
    cfg = T_difuser.DiFuserConfig(num_registers=64, seed=2)
    add = _insertions(tg.n, 30)
    sync = SketchStore(device="cpu")
    sk = sync.get_or_build(tg, cfg).key
    sync.attach_plan(sk, t_plan(sync.entry(sk).graph, 3, seed=2, device="cpu"))
    want = apply_delta(sync, sk, GraphDelta.make(add=add), backend="serial")
    with AsyncInfluenceEngine(store=SketchStore(device="cpu"), deadline_ms=10.0) as aeng:
        key = aeng.engine.register(tg, cfg)
        entry = aeng.store.entry(key)
        aeng.store.attach_plan(key, t_plan(entry.graph, 3, seed=2, device="cpu"))
        old = _bytes(entry.matrix)
        rep = aeng.apply_delta_async(key, GraphDelta.make(add=add),
                                     backend="serial").result(WAIT)
        aeng.drain(WAIT)
        new = aeng.store.entry(key)
    assert rep.repair_backend == "serial" and rep.shards_swept == want.shards_swept
    assert rep.repair_sweeps == want.repair_sweeps
    assert new is not entry and new.version == sync.entry(sk).version > entry.version
    assert _bytes(entry.matrix) == old                  # version N untouched
    assert _bytes(new.matrix) == _bytes(sync.entry(sk).matrix)
