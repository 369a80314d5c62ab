"""The port's influence query service (``repro_torch.service``: store,
queries, engine; ``runtime.InfluenceSession``; the ``serve`` launcher)
against the reference's, on the CPU: store matrices byte for byte (1 and 2
banks, the ``serial`` backend), spread and probe estimates to rtol 1e-6,
marginal gains to 1e-6 of the largest estimate with the candidate, warm
top-k seeds byte-equal to cold ones, the engine's memo, dedupe and batch
flags equal, snapshots loading in both directions."""
import functools

import numpy as np
import pytest
import torch

from repro.core import difuser as R_difuser
from repro.graphs import rmat_graph as ref_rmat
from repro.partition import plan_partition as r_plan
from repro.runtime import InfluenceSession as RSession
from repro.runtime import RunSpec as RSpec
from repro.service import InfluenceEngine as REngine
from repro.service import Request as RRequest
from repro.service import SketchStore as RStore
from repro.service import queries as RQ
from repro_torch.core import difuser as T_difuser
from repro_torch.graphs import rmat_graph as port_rmat
from repro_torch.kernels import counters
from repro_torch.launch.serve_im import make_workload
from repro_torch.partition import plan_partition as t_plan
from repro_torch.runtime import InfluenceSession, RunSpec
from repro_torch.service import InfluenceEngine, Request, SketchStore
from repro_torch.service import queries as TQ


@functools.lru_cache(maxsize=None)
def _graphs():
    return (ref_rmat(9, edge_factor=8, seed=21, setting="w1"),
            port_rmat(9, edge_factor=8, seed=21, setting="w1"))


def _cfgs(num_regs=64, estimator="hll", model="wc"):
    return (R_difuser.DiFuserConfig(num_registers=num_regs, seed=2, estimator=estimator,
                                    model=model),
            T_difuser.DiFuserConfig(num_registers=num_regs, seed=2, estimator=estimator,
                                    model=model))


def _specs(**kw):
    return RSpec(**kw), RunSpec(**kw)


@functools.lru_cache(maxsize=None)
def _served(num_regs=64, estimator="hll", banks=1, backend=None):
    """(reference engine, key, port engine, key) on the shared graph."""
    rg, tg = _graphs()
    rc, tc = _cfgs(num_regs, estimator)
    rs, ts = _specs(backend="serial", mu_v=2, mu_s=2, partition="degree") \
        if backend == "serial" else (None, None)
    r_eng = REngine(RStore(num_banks=banks, spec=rs))
    t_eng = InfluenceEngine(SketchStore(num_banks=banks, spec=ts, device="cpu"))
    return r_eng, r_eng.register(rg, rc), t_eng, t_eng.register(tg, tc)


def _as_bytes(m) -> bytes:
    return (m.numpy() if isinstance(m, torch.Tensor) else np.asarray(m)).tobytes()


@pytest.mark.parametrize("banks,backend", [(1, None), (2, None), (2, "serial")])
def test_store_matches_reference(banks, backend):
    r_eng, rk, t_eng, tk = _served(banks=banks, backend=backend)
    want, got = r_eng.store.entry(rk), t_eng.store.entry(tk)
    assert tk.graph_key == rk.graph_key
    assert got.num_banks == banks and got.build_iters == want.build_iters
    np.testing.assert_array_equal(got.x, want.x)
    assert got.matrix.dtype == torch.int8 and got.matrix.is_contiguous()
    assert _as_bytes(got.matrix) == _as_bytes(want.matrix)
    for b_got, b_want in zip(got.banks, want.banks):
        assert _as_bytes(b_got) == _as_bytes(b_want)
    np.testing.assert_array_equal(got.graph.src, want.graph.src)
    assert got.device_bytes() == got.matrix.numel()


def _queries(n, count=48, seed=5):
    return [q for q in make_workload(n, count, k=4, seed=seed)
            if not isinstance(q, TQ.TopKSeeds)]


def _to_ref(q):
    if isinstance(q, TQ.SpreadEstimate):
        return RQ.SpreadEstimate(q.candidates)
    if isinstance(q, TQ.MarginalGain):
        return RQ.MarginalGain(q.candidate, q.committed)
    if isinstance(q, TQ.CoverageProbe):
        return RQ.CoverageProbe(q.vertices)
    return RQ.TopKSeeds(q.k)


def _check_answers(want, got, entry):
    for w, g in zip(want, got):
        assert g.batch_size == w.batch_size and g.backend == w.backend == "single:host"
        q = g.query
        if isinstance(q, TQ.CoverageProbe):
            np.testing.assert_allclose(g.value["est"], w.value["est"], rtol=1e-6, atol=0)
            np.testing.assert_array_equal(g.value["max_register"], w.value["max_register"])
        elif isinstance(q, TQ.MarginalGain):
            with_c = TQ.spread_estimates(entry, [q.committed + (q.candidate,)])[0]
            assert abs(g.value - w.value) <= 1e-6 * abs(with_c), (g.value, w.value)
        else:
            np.testing.assert_allclose(g.value, w.value, rtol=1e-6, atol=0)


@pytest.mark.parametrize("num_regs", [64, 38])
@pytest.mark.parametrize("estimator", ["hll", "fm_mean"])
def test_queries_match_reference(estimator, num_regs):
    r_eng, rk, t_eng, tk = _served(num_regs, estimator)
    entry = t_eng.store.entry(tk)
    qs = _queries(entry.graph.n)
    assert {type(q).__name__ for q in qs} == {"SpreadEstimate", "MarginalGain",
                                             "CoverageProbe"}
    counters.reset()
    got = t_eng.run([Request(tk, q) for q in qs])
    if estimator == "hll":
        assert counters.PLAIN_CALLS["sketch_cardinality"] == 4   # 1 + 2 + 1 batches
    else:
        assert not counters.PLAIN_CALLS
    want = r_eng.run([RRequest(rk, _to_ref(q)) for q in qs])
    _check_answers(want, got, entry)
    # one at a time
    for q in qs[:6]:
        _check_answers([r_eng(rk, _to_ref(q))], [t_eng(tk, q)], entry)


def test_answers_do_not_depend_on_banks():
    _, _, one, k1 = _served()
    _, _, two, k2 = _served(banks=2)
    qs = _queries(_graphs()[1].n, seed=8)
    a = one.run([Request(k1, q) for q in qs])
    b = two.run([Request(k2, q) for q in qs])
    for x, y in zip(a, b):
        if isinstance(x.value, dict):
            np.testing.assert_array_equal(x.value["est"], y.value["est"])
        else:
            assert x.value == y.value


def test_sentinel_padding_is_inert():
    _, _, t_eng, tk = _served()
    entry = t_eng.store.entry(tk)
    s = (4, 9, 100)
    a = TQ.spread_estimates(entry, [s])
    b = TQ.spread_estimates(entry, [s, (), (7,)], length=8)
    assert a[0] == b[0] and b[1] == 0.0
    with pytest.raises(ValueError, match="unknown estimator"):
        TQ.row_statistics(entry.matrix[:2], "median")


def test_max_batch_splits_a_class_into_chunks():
    rg, tg = _graphs()
    rc, tc = _cfgs()
    r_eng = REngine(RStore(), max_batch=4)
    t_eng = InfluenceEngine(SketchStore(device="cpu"), max_batch=4)
    rk, tk = r_eng.register(rg, rc), t_eng.register(tg, tc)
    rng = np.random.default_rng(3)
    qs = [TQ.SpreadEstimate(rng.integers(0, tg.n, 3)) for _ in range(11)]
    qs += [TQ.CoverageProbe([5, 6]) for _ in range(5)]
    got = t_eng.run([Request(tk, q) for q in qs])
    want = r_eng.run([RRequest(rk, _to_ref(q)) for q in qs])
    assert [r.batch_size for r in got] == [r.batch_size for r in want] == \
        [4] * 8 + [3] * 3 + [4] * 4 + [1]
    _check_answers(want, got, t_eng.store.entry(tk))


def test_warm_topk_matches_cold_and_reference():
    r_eng, rk, t_eng, tk = _served(banks=2)
    entry = t_eng.store.entry(tk)
    _, tc = _cfgs()
    cold = T_difuser.find_seeds(_graphs()[1], 6, tc, x=entry.x, device="cpu")
    counters.reset()
    warm = t_eng(tk, TQ.TopKSeeds(6)).value
    assert "sketch_fill" not in counters.PLAIN_CALLS or warm.rebuilds.any()
    ref = r_eng(rk, RQ.TopKSeeds(6)).value
    for field in ("seeds", "est_gains", "scores", "rebuilds"):
        np.testing.assert_array_equal(getattr(warm, field), getattr(cold, field))
    np.testing.assert_array_equal(warm.seeds, ref.seeds)
    np.testing.assert_array_equal(warm.rebuilds, ref.rebuilds)
    np.testing.assert_allclose(warm.scores, ref.scores, rtol=1e-6, atol=0)


def test_topk_memo_and_dedupe_match_reference():
    rg, tg = _graphs()
    rc, tc = _cfgs(num_regs=32)
    r_eng, t_eng = REngine(RStore()), InfluenceEngine(SketchStore(device="cpu"))
    rk, tk = r_eng.register(rg, rc), t_eng.register(tg, tc)
    ks = [3, 3, 2, 3, 2]

    def flags(results):
        return [(r.cache_hit, r.deduped, r.backend, r.batch_size, r.latency_s == 0.0)
                for r in results]

    for _ in range(2):   # the second run is all memo hits
        got = t_eng.run([Request(tk, TQ.TopKSeeds(k)) for k in ks])
        want = r_eng.run([RRequest(rk, RQ.TopKSeeds(k)) for k in ks])
        assert flags(got) == flags(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.value.seeds, w.value.seeds)
    assert all(r.cache_hit for r in got)
    t_eng.clear_topk_memo()
    assert not t_eng(tk, TQ.TopKSeeds(3)).cache_hit


def test_unknown_key_is_refused():
    _, _, t_eng, tk = _served()
    other = InfluenceEngine(SketchStore(device="cpu"))
    with pytest.raises(KeyError, match="not registered"):
        other.submit(tk, TQ.TopKSeeds(2))
    with pytest.raises(KeyError, match="not registered"):
        other.run([Request(tk, TQ.TopKSeeds(2))])


def test_store_hit_checks_x():
    _, tg = _graphs()
    _, tc = _cfgs()
    store = SketchStore(device="cpu")
    e = store.get_or_build(tg, tc)
    assert store.get_or_build(tg, tc) is e and len(store) == 1
    with pytest.raises(ValueError, match="different sample vector"):
        store.get_or_build(tg, tc, x=np.arange(64, dtype=np.uint32))
    two = SketchStore(num_banks=2, device="cpu").get_or_build(tg, tc)
    m = two.matrix.clone()
    two.set_matrix(m)
    assert two.version == 1 and two.num_banks == 2 and torch.equal(two.matrix, m)
    with pytest.raises(ValueError, match="do not split"):
        SketchStore(num_banks=3, device="cpu").get_or_build(tg, tc)


def test_runspec_from_config_matches_reference():
    rc, tc = _cfgs(num_regs=96, estimator="fm_mean", model="lt")
    rs, ts = _specs(backend="serial", mu_v=2, partition="degree")
    got = RunSpec.from_config(tc, base=ts, mu_s=2)
    want = RSpec.from_config(rc, base=rs, mu_s=2)
    for f in ("num_registers", "seed", "estimator", "model", "backend", "mu_v", "mu_s",
              "partition"):
        assert getattr(got, f) == getattr(want, f), f
    assert RunSpec.from_config(None, base=ts) == ts == ts.with_()
    assert got.with_(mu_v=4).mu_v == 4 and got.difuser_config() == tc


def test_attach_plan_planned_matrix_matches_reference():
    r_eng, rk, t_eng, tk = _served()
    rs, ts = r_eng.store, t_eng.store
    re_, te = rs.entry(rk), ts.entry(tk)
    rp = r_plan(re_.graph, 4, mu_s=1, strategy="degree", x=re_.x, seed=2)
    tp = t_plan(te.graph, 4, mu_s=1, strategy="degree", x=te.x, seed=2, device="cpu")
    np.testing.assert_array_equal(tp.perm, rp.perm)
    rs.attach_plan(rk, rp)
    ts.attach_plan(tk, tp)
    planned = te.planned_matrix()
    assert planned.shape[0] == tp.n_pad
    assert _as_bytes(planned) == _as_bytes(re_.planned_matrix())
    verts = np.array([0, 5, 300, te.graph.n - 1])
    np.testing.assert_array_equal(tp.owner_of(verts), rp.owner_of(verts))


def _spread_all(eng, key, sets, mod):
    return [eng(key, mod.SpreadEstimate(s)).value for s in sets]


@pytest.mark.parametrize("with_plan", [False, True])
def test_snapshots_load_in_both_directions(tmp_path, with_plan):
    rg, tg = _graphs()
    rc, tc = _cfgs(num_regs=38)
    r_store, t_store = RStore(), SketchStore(device="cpu")
    rk = r_store.get_or_build(rg, rc).key
    tk = t_store.get_or_build(tg, tc).key
    if with_plan:
        r_store.attach_plan(rk, r_plan(r_store.entry(rk).graph, 2, strategy="random",
                                       seed=1))
        t_store.attach_plan(tk, t_plan(t_store.entry(tk).graph, 2, strategy="random",
                                       seed=1))
    sets = [(1, 2), (40,), (7, 300, 12, 5)]
    # the reference saves, the port loads
    r_store.save(str(tmp_path / "ref"), rk)
    got = SketchStore(num_banks=2, device="cpu").load(str(tmp_path / "ref.npz"))
    assert got.key == tk and got.num_banks == 2
    assert _as_bytes(got.matrix) == _as_bytes(r_store.entry(rk).matrix)
    assert (got.plan is not None) == with_plan
    if with_plan:
        np.testing.assert_array_equal(got.plan.perm, r_store.entry(rk).plan.perm)
    # the port saves, the reference loads
    t_store.save(str(tmp_path / "port"), tk)
    back = RStore().load(str(tmp_path / "port"))
    assert back.key == rk and back.cfg.impl == "ref"
    assert _as_bytes(back.matrix) == _as_bytes(t_store.entry(tk).matrix)
    r_eng, t_eng = REngine(RStore()), InfluenceEngine(SketchStore(num_banks=2, device="cpu"))
    r_eng.store.load(str(tmp_path / "port.npz"))
    t_eng.store.load(str(tmp_path / "ref.npz"))
    np.testing.assert_allclose(_spread_all(t_eng, tk, sets, TQ),
                               _spread_all(r_eng, rk, sets, RQ), rtol=1e-6, atol=0)


def test_session_matches_reference():
    rg, tg = _graphs()
    rs, ts = _specs(num_registers=64, seed=4)
    r_sess, t_sess = RSession(rg, rs, num_banks=2), InfluenceSession(tg, ts, num_banks=2,
                                                                    device="cpu")
    want, got = r_sess.find_seeds(5), t_sess.find_seeds(5)
    np.testing.assert_array_equal(got.seeds, want.seeds)
    assert t_sess.last_report.backend == r_sess.last_report.backend == "single"
    rm, r_it, rx = r_sess.build_sketch_matrix(reg_offset=64)
    tm, t_it, tx = t_sess.build_sketch_matrix(reg_offset=64)
    assert t_it == r_it and _as_bytes(tm) == _as_bytes(rm)
    np.testing.assert_array_equal(tx, rx)
    warm = t_sess.find_seeds_warm(5)
    np.testing.assert_array_equal(warm.seeds, got.seeds)
    np.testing.assert_array_equal(warm.scores, got.scores)
    assert t_sess.entry() is t_sess.entry()
    assert _as_bytes(t_sess.entry().matrix) == _as_bytes(r_sess.entry().matrix)
    from repro.graphs.structs import GraphDelta as RDelta
    from repro_torch.graphs import GraphDelta

    rng = np.random.default_rng(6)
    add = (rng.integers(0, tg.n, 30), rng.integers(0, tg.n, 30))
    w_rep = r_sess.apply_delta(RDelta.make(add=add))
    g_rep = t_sess.apply_delta(GraphDelta.make(add=add))
    assert (g_rep.repair_sweeps, g_rep.banks_touched, g_rep.rebuilt) == \
        (w_rep.repair_sweeps, w_rep.banks_touched, w_rep.rebuilt)
    assert t_sess.graph is t_sess.entry().graph and t_sess.graph.m_real == r_sess.graph.m_real
    np.testing.assert_array_equal(t_sess.find_seeds_warm(5).seeds,
                                  t_sess.find_seeds(5).seeds)
    np.testing.assert_array_equal(t_sess.find_seeds_warm(5).seeds,
                                  r_sess.find_seeds_warm(5).seeds)


def test_serve_launcher_matches_reference(tmp_path):
    from repro.launch import serve_im as R_serve
    from repro_torch.launch import serve_im as T_serve

    argv = ["--graph", "rmat:9", "--registers", "64", "--queries", "64"]
    want = R_serve.run(argv)
    got, sess = T_serve.run(argv + ["--device", "cpu", "--attach-plan", "--plan-shards", "4",
                                    "--save", str(tmp_path / "idx")], return_session=True)
    assert set(got) == set(want) - {"residency"}
    for key in ("num_queries", "cache_hits", "deduped", "by_backend", "backend", "serving"):
        assert got[key] == want[key], key
    entry = sess.entry()
    assert entry.plan is not None and entry.plan.mu_v == 4
    loaded = SketchStore(device="cpu").load(str(tmp_path / "idx"))
    assert _as_bytes(loaded.matrix) == _as_bytes(entry.matrix)


def test_serve_command_runs():
    from repro_torch.__main__ import main

    with pytest.raises(SystemExit, match="unknown command"):
        main(["train"])
    main(["serve", "--graph", "rmat:7", "--registers", "32", "--queries", "16",
          "--device", "cpu"])


def test_serial_run_takes_a_precomputed_plan():
    from repro.runtime import run as r_run
    from repro_torch.runtime import get_backend, run

    rg, tg = _graphs()
    rs, ts = _specs(num_registers=32, seed=2, backend="serial", mu_v=2, mu_s=2)
    rp = r_plan(rg.sorted_by_dst(), 2, mu_s=2, strategy="random", seed=4)
    tp = t_plan(tg.sorted_by_dst(), 2, mu_s=2, strategy="random", seed=4)
    want = r_run(rg, 3, rs, plan=rp)
    got = run(tg, 3, ts, plan=tp, device="cpu")
    assert got.partition.plan is tp
    np.testing.assert_array_equal(got.result.seeds, want.result.seeds)
    g_sorted, x = T_difuser.normalize_inputs(tg, ts.difuser_config())
    m, _ = get_backend("serial").build_matrix(g_sorted, ts, x, normalized=True, plan=tp,
                                              device="cpu")
    m_single, _, _ = T_difuser.build_sketch_matrix(tg, ts.difuser_config(), device="cpu")
    assert torch.equal(m, m_single)
