"""The port's async serving (``repro_torch.service.async_engine``, the
scheduler, the evictor, the store's eviction and double buffer) on the CPU.

The reference's cases (``tests/test_async_service.py``) at its sizes (rmat:8,
J = 64): the async layer reorders work but never changes it, so every answer
is byte-equal to the port's synchronous engine's for the same query against
the same entry version. On top of those: the answers against the reference's
engine (spread and probe estimates to rtol 1e-6, largest registers and top-k
seeds equal), the scheduler's and the evictor's decisions against the
reference classes', version N's bank bytes held across a shadow's mutations,
failures landing on futures, and ``serve --async``'s ``async:`` line.

Every wait has a timeout and every engine is closed by its ``with`` block.
"""
import re
import time

import numpy as np
import pytest
import torch

from repro.core import difuser as R_difuser
from repro.graphs import rmat_graph as ref_rmat
from repro.service import CostAwareEvictor as RCostAwareEvictor
from repro.service import InfluenceEngine as REngine
from repro.service import Request as RRequest
from repro.service import SketchStore as RStore
from repro.service import queries as RQ
from repro.service.scheduler import MicroBatchScheduler as RScheduler
from repro_torch.core.difuser import DiFuserConfig
from repro_torch.graphs import rmat_graph
from repro_torch.graphs.structs import GraphDelta
from repro_torch.obs import flight
from repro_torch.runtime import RunSpec
from repro_torch.service import (AsyncInfluenceEngine, CostAwareEvictor, CoverageProbe,
                                 InfluenceEngine, MarginalGain, Request, SketchStore,
                                 SpreadEstimate, TopKSeeds, apply_delta)
from repro_torch.service import queries as TQ
from repro_torch.service.scheduler import MicroBatchScheduler

WAIT = 60      # seconds: the longest any future or drain is waited for


@pytest.fixture(autouse=True)
def flight_dumps_in_tmp(tmp_path, monkeypatch):
    """SLO breaches and stalls dump the flight ring: into ``tmp_path``."""
    monkeypatch.setenv(flight.ENV_DIR, str(tmp_path))


@pytest.fixture(scope="module")
def graphs():
    g1 = rmat_graph(8, edge_factor=8, seed=1, setting="w1")
    g2 = rmat_graph(8, edge_factor=8, seed=2, setting="w1")
    return g1, g2, DiFuserConfig(num_registers=64, seed=0)


def _store(**kw):
    return SketchStore(device="cpu", **kw)


def _mixed_stream(n, num, seed, k=4):
    """A shuffled mixed-class query stream over vertex ids < n."""
    rng = np.random.default_rng(seed)
    out = []
    for kind in rng.integers(0, 4, size=num):
        if kind == 0:
            out.append(TopKSeeds(k))
        elif kind == 1:
            out.append(SpreadEstimate(rng.integers(0, n, int(rng.integers(1, 5)))))
        elif kind == 2:
            out.append(MarginalGain(int(rng.integers(0, n)),
                                    rng.integers(0, n, int(rng.integers(0, 4)))))
        else:
            out.append(CoverageProbe(rng.integers(0, n, int(rng.integers(1, 4)))))
    return out


def _same_value(a, b) -> bool:
    if isinstance(a, dict):
        return (a["est"].tobytes() == b["est"].tobytes()
                and a["max_register"].tobytes() == b["max_register"].tobytes())
    if isinstance(a, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    return (a.seeds.tobytes() == b.seeds.tobytes()
            and a.est_gains.tobytes() == b.est_gains.tobytes()
            and a.scores.tobytes() == b.scores.tobytes())


def _run_both(g1, g2, cfg, stream, which, deadline_ms=25.0, gate=False):
    """Serve one (key, query) stream sync and async; return both results.
    ``gate``: hold the engine's lock while submitting and until every flush
    window has run out, so the serve thread takes all buckets in one flush
    (without it, whether two buckets share a flush depends on how soon the
    serve thread wakes)."""
    sync = InfluenceEngine(_store())
    ks = [sync.register(g1, cfg), sync.register(g2, cfg)]
    sync_res = sync.run([Request(key=ks[w], query=q) for w, q in zip(which, stream)])
    with AsyncInfluenceEngine(store=_store(), deadline_ms=deadline_ms) as aeng:
        ka = [aeng.engine.register(g1, cfg), aeng.engine.register(g2, cfg)]
        if gate:
            with aeng._cv:
                futs = [aeng.submit(ka[w], q) for w, q in zip(which, stream)]
                time.sleep(2 * aeng._sched.flush_window_s)
        else:
            futs = [aeng.submit(ka[w], q) for w, q in zip(which, stream)]
        aeng.drain(WAIT)
        async_res = [f.result(WAIT) for f in futs]
    return sync_res, async_res


# -- async == sync ------------------------------------------------------------

def test_async_equals_sync_mixed_stream(graphs):
    """A shuffled mixed-class stream over two resident graphs is byte-equal
    between the synchronous engine and the async pipeline."""
    g1, g2, cfg = graphs
    stream = _mixed_stream(g1.n, 48, seed=11)
    which = np.random.default_rng(12).integers(0, 2, size=len(stream))
    sync_res, async_res = _run_both(g1, g2, cfg, stream, which)
    assert {type(q).__name__ for q in stream} == {"TopKSeeds", "SpreadEstimate",
                                                 "MarginalGain", "CoverageProbe"}
    for s, a in zip(sync_res, async_res):
        assert _same_value(s.value, a.value), s.query


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_async_equals_sync_random_streams(graphs, seed):
    """The property form (the reference draws it with hypothesis): seeded
    streams of random length and routing, byte-equal answers."""
    g1, g2, cfg = graphs
    rng = np.random.default_rng(100 + seed)
    num = int(rng.integers(1, 25))
    stream = _mixed_stream(g1.n, num, seed=int(rng.integers(0, 2**16)))
    which = rng.integers(0, 2, size=num)
    sync_res, async_res = _run_both(g1, g2, cfg, stream, which, deadline_ms=10.0)
    for s, a in zip(sync_res, async_res):
        assert _same_value(s.value, a.value), s.query


def test_cross_entry_dispatch_bit_identical(graphs):
    """SpreadEstimate buckets against two graphs are answered in one stacked
    batch, and the values stay byte-equal."""
    g1, g2, cfg = graphs
    rng = np.random.default_rng(7)
    stream = [SpreadEstimate(rng.integers(0, g1.n, 3)) for _ in range(24)]
    which = [i % 2 for i in range(len(stream))]
    sync_res, async_res = _run_both(g1, g2, cfg, stream, which, deadline_ms=60.0, gate=True)
    assert all(r.backend == "cross:host" for r in async_res)
    for s, a in zip(sync_res, async_res):
        assert _same_value(s.value, a.value)


@pytest.mark.parametrize("room,kept", [(2.5, False), (5.0, True)])
def test_budget_covers_the_cross_entry_stack(graphs, room, kept):
    """The budget covers the cross-entry stack as well as the resident
    entries: with room for the two entries (``room`` entries' bytes) but not
    for their stack besides, the budget pass after the cross batch drops the
    stack and evicts nothing; with room for both, the stack stays."""
    g1, g2, cfg = graphs
    rng = np.random.default_rng(8)
    stream = [SpreadEstimate(rng.integers(0, g1.n, 3)) for _ in range(8)]
    sync = InfluenceEngine(_store())
    ks = [sync.register(g1, cfg), sync.register(g2, cfg)]
    want = sync.run([Request(key=ks[i % 2], query=q) for i, q in enumerate(stream)])
    per = max(sync.store.entry(k).device_bytes() for k in ks)
    with AsyncInfluenceEngine(store=_store(), deadline_ms=60.0,
                              max_resident_mb=room * per / 2**20) as aeng:
        ka = [aeng.engine.register(g1, cfg), aeng.engine.register(g2, cfg)]
        with aeng._cv:
            futs = [aeng.submit(ka[i % 2], q) for i, q in enumerate(stream)]
            time.sleep(2 * aeng._sched.flush_window_s)
        aeng.drain(WAIT)
        got = [f.result(WAIT) for f in futs]
    # after close: the serve thread's budget pass follows the batch's answers
    assert all(r.backend == "cross:host" for r in got)
    assert (aeng._concat_cache is not None) == kept
    assert aeng.held_bytes() <= aeng.evictor.budget_bytes
    assert not any(aeng.store.is_evicted(k) for k in ka)
    for s, a in zip(want, got):
        assert _same_value(s.value, a.value)


def _to_ref(q):
    if isinstance(q, SpreadEstimate):
        return RQ.SpreadEstimate(q.candidates)
    if isinstance(q, MarginalGain):
        return RQ.MarginalGain(q.candidate, q.committed)
    if isinstance(q, CoverageProbe):
        return RQ.CoverageProbe(q.vertices)
    return RQ.TopKSeeds(q.k)


def test_async_answers_match_reference_engine(graphs):
    """The async answers against the reference's synchronous engine on the
    same graphs and x: spread and probe estimates to rtol 1e-6 (the
    tolerance of tests/test_torch_service.py), marginal gains to 1e-6 of the
    estimate with the candidate, largest registers and top-k seeds equal."""
    g1, g2, cfg = graphs
    rc = R_difuser.DiFuserConfig(num_registers=64, seed=0)
    r_eng = REngine(RStore())
    rk = [r_eng.register(ref_rmat(8, edge_factor=8, seed=s, setting="w1"), rc)
          for s in (1, 2)]
    stream = _mixed_stream(g1.n, 40, seed=5)
    which = np.random.default_rng(6).integers(0, 2, size=len(stream))
    want = r_eng.run([RRequest(rk[w], _to_ref(q)) for w, q in zip(which, stream)])
    with AsyncInfluenceEngine(store=_store(), deadline_ms=20.0) as aeng:
        ka = [aeng.engine.register(g1, cfg), aeng.engine.register(g2, cfg)]
        assert [k.graph_key for k in ka] == [k.graph_key for k in rk]
        got = [f.result(WAIT) for f in [aeng.submit(ka[w], q)
                                        for w, q in zip(which, stream)]]
        entries = [aeng.store.entry(k) for k in ka]
    for w, g, r in zip(which, got, want):
        q = g.query
        if isinstance(q, TopKSeeds):
            np.testing.assert_array_equal(g.value.seeds, np.asarray(r.value.seeds))
        elif isinstance(q, CoverageProbe):
            np.testing.assert_allclose(g.value["est"], r.value["est"], rtol=1e-6, atol=0)
            np.testing.assert_array_equal(g.value["max_register"],
                                          np.asarray(r.value["max_register"]))
        elif isinstance(q, MarginalGain):
            with_c = TQ.spread_estimates(entries[w], [q.committed + (q.candidate,)])[0]
            assert abs(g.value - r.value) <= 1e-6 * abs(with_c), (g.value, r.value)
        else:
            np.testing.assert_allclose(g.value, r.value, rtol=1e-6, atol=0)


# -- the double buffer: serve N while N+1 is built ------------------------------

def test_delta_swap_overlaps_serving(graphs):
    """A query submitted while the repair is in flight is answered from
    version N; the swap lands afterwards, and later queries are answered
    from the repaired index, equal to a cold build of the new graph."""
    g1, _, cfg = graphs
    observed = {}

    class Hooked(AsyncInfluenceEngine):
        def _before_swap(self, key):
            entry = self.store.entry(key)
            fut = self.submit(key, SpreadEstimate((1, 2, 3)))
            observed["value"] = fut.result(WAIT).value
            observed["version_during"] = entry.version

    with Hooked(store=_store(), deadline_ms=20.0) as aeng:
        key = aeng.engine.register(g1, cfg)
        v0 = aeng.store.entry(key).version
        pre = aeng.submit(key, SpreadEstimate((1, 2, 3))).result(WAIT).value
        rng = np.random.default_rng(3)
        delta = GraphDelta.make(add=(rng.integers(0, g1.n, 16), rng.integers(0, g1.n, 16)))
        rep = aeng.apply_delta_async(key, delta).result(WAIT)
        assert rep.added == 16 and rep.repair_sweeps > 0
        post = aeng.submit(key, SpreadEstimate((1, 2, 3))).result(WAIT).value
        entry = aeng.store.entry(key)
    assert observed["version_during"] == v0 and observed["value"] == pre
    assert entry.version > v0
    cold = InfluenceEngine(_store())
    fresh = cold.store.get_or_build(entry.graph, cfg, entry.x)
    assert entry.matrix.numpy().tobytes() == fresh.matrix.numpy().tobytes()
    assert post == cold(fresh.key, SpreadEstimate((1, 2, 3))).value


def test_stale_topk_rebuilds_off_serving_path(graphs):
    """A removal delta leaves the entry stale; an async TopKSeeds hands the
    rebuild to the mutation thread (hold and requeue) and resolves against
    the rebuilt index, as the synchronous lazy rebuild does."""
    g1, _, cfg = graphs
    sync = InfluenceEngine(_store())
    ks = sync.register(g1, cfg)
    rem = (sync.store.entry(ks).graph.src[:4], sync.store.entry(ks).graph.dst[:4])
    with AsyncInfluenceEngine(store=_store(), deadline_ms=20.0) as aeng:
        ka = aeng.engine.register(g1, cfg)
        aeng.apply_delta_async(ka, GraphDelta.make(remove=rem)).result(WAIT)
        assert aeng.store.entry(ka).stale
        res = aeng.submit(ka, TopKSeeds(5)).result(WAIT)
        assert not aeng.store.entry(ka).stale
        assert aeng.store.entry(ka).rebuilds == 1
    apply_delta(sync.store, ks, GraphDelta.make(remove=rem))
    want = sync(ks, TopKSeeds(5)).value
    assert _same_value(res.value, want)


@pytest.mark.parametrize("banks,num_regs", [(1, 64), (2, 38)])
def test_shadow_mutations_leave_version_n_bytes_unchanged(graphs, banks, num_regs):
    """Torch tensors, unlike jax arrays, can be written in place: a shadow
    shares version N's bank tensors, so an insertion repair, a rebuild and a
    set_matrix of the shadow must leave N's banks byte for byte as they
    were, while the shadow's entry moves on."""
    g1, _, _ = graphs
    cfg = DiFuserConfig(num_registers=num_regs, seed=4)
    store = _store(num_banks=banks)
    entry = store.get_or_build(g1, cfg)
    key = entry.key
    held = list(entry.banks)
    saved = [b.numpy().tobytes() for b in held]
    rng = np.random.default_rng(9)
    delta = GraphDelta.make(add=(rng.integers(0, g1.n, 32), rng.integers(0, g1.n, 32)))

    shadow = store.shadow(key)
    clone = shadow.entry(key)
    assert clone is not entry and all(a is b for a, b in zip(clone.banks, held))
    rep = apply_delta(shadow, key, delta)
    assert rep.banks_touched > 0 and not rep.rebuilt
    assert any(not torch.equal(a, b) for a, b in zip(clone.banks, held))
    shadow.rebuild(key)
    clone.set_matrix(torch.zeros_like(clone.matrix))
    assert store.entry(key) is entry and entry.version == 0
    assert [b.numpy().tobytes() for b in held] == saved
    assert [b.numpy().tobytes() for b in entry.banks] == saved
    old = store.swap_entry(key, clone)
    assert old is entry and store.entry(key) is clone
    assert [b.numpy().tobytes() for b in held] == saved


# -- eviction -------------------------------------------------------------------

def test_eviction_keeps_bytes_under_budget_and_rebuilds(graphs):
    """Resident bytes stay under the budget; an evicted entry is rebuilt on
    its next touch, byte-equal, its version past the evicted one."""
    g1, g2, cfg = graphs
    g3 = rmat_graph(8, edge_factor=8, seed=3, setting="w1")
    store = _store()
    entries = [store.get_or_build(g, cfg) for g in (g1, g2, g3)]
    per = entries[0].device_bytes()
    before = {e.key: e.matrix.numpy().tobytes() for e in entries}
    budget = 2 * per + per // 2     # room for two of the three
    ev = CostAwareEvictor(budget)
    for e in entries:               # equal rebuild cost: recency decides
        e.build_time_s = 1.0
    now = time.monotonic()
    ev.touch(entries[1].key, now)   # the hottest
    ev.touch(entries[2].key, now - 0.5)
    ev.touch(entries[0].key, now - 5.0)  # the coldest: the victim
    assert ev.enforce(store) == [entries[0].key]
    assert store.resident_bytes() <= budget
    assert store.is_evicted(entries[0].key)
    assert len(store) == 3 and entries[0].key in store
    assert set(store.keys()) == set(before) and entries[0].key not in store.resident_keys()
    e0 = store.entry(entries[0].key)
    assert not store.is_evicted(entries[0].key)
    assert e0.evictions == 1 and e0.version == entries[0].version + 1
    assert e0.matrix.numpy().tobytes() == before[entries[0].key]
    assert store.evict(entries[1].key) == per and store.evict(entries[1].key) == 0
    store.invalidate(entries[1].key)
    assert entries[1].key not in store
    with pytest.raises(KeyError):
        store.evict(entries[1].key)


def test_async_engine_enforces_resident_budget(graphs):
    """With max_resident_mb set, admissions beyond the budget evict the
    coldest entry, and queries against it are still answered right (it is
    rebuilt on touch)."""
    g1, g2, cfg = graphs
    g3 = rmat_graph(8, edge_factor=8, seed=3, setting="w1")
    probe = _store().get_or_build(g1, cfg)
    budget_mb = (2 * probe.device_bytes() + 100) / 2**20
    sync = InfluenceEngine(_store())
    want = {}
    for g in (g1, g2, g3):
        k = sync.register(g, cfg)
        want[k] = sync(k, SpreadEstimate((0, 1))).value
    with AsyncInfluenceEngine(store=_store(), deadline_ms=20.0,
                              max_resident_mb=budget_mb) as aeng:
        keys = [aeng.register_async(g, cfg).result(WAIT) for g in (g1, g2, g3)]
        aeng.drain(WAIT)
        assert aeng.store.resident_bytes() <= aeng.evictor.budget_bytes
        assert any(aeng.store.is_evicted(k) for k in keys)
        for k in keys:
            got = aeng.submit(k, SpreadEstimate((0, 1))).result(WAIT)
            assert got.value == want[k]
    # after close: the serve thread's last budget pass follows its last answer
    summary = aeng.admission_summary()
    assert summary["budget_bytes"] == aeng.evictor.budget_bytes
    assert summary["completed"] == 3 and summary["resident_bytes"] <= summary["budget_bytes"]


def test_stale_entries_are_not_evictable(graphs):
    """A stale matrix depends on its history: evicting it would change
    answers, so the store refuses and the evictor skips it."""
    g1, _, cfg = graphs
    store = _store()
    key = InfluenceEngine(store).register(g1, cfg)
    e = store.entry(key)
    apply_delta(store, key, GraphDelta.make(remove=(e.graph.src[:2], e.graph.dst[:2])))
    assert store.entry(key).stale
    with pytest.raises(ValueError):
        store.evict(key)
    assert CostAwareEvictor(0).enforce(store) == []


class _FakeEntry:
    residency = "host"

    def __init__(self, key, nbytes, build_s, stale=False):
        self.key, self._bytes, self.build_time_s, self.stale = key, nbytes, build_s, stale

    def device_bytes(self):
        return self._bytes


class _FakeStore:
    """What the evictor reads of a store, for both packages' evictors."""

    def __init__(self, entries):
        self._entries = {e.key: e for e in entries}

    def resident_bytes(self):
        return sum(e.device_bytes() for e in self._entries.values())

    def resident_keys(self):
        return list(self._entries)

    def entry(self, key):
        return self._entries[key]

    def evict(self, key):
        return self._entries.pop(key).device_bytes()


def test_evictor_decisions_match_reference():
    """The same touches on one injected clock, the same budgets: the port's
    evictor picks the same victims in the same order as the reference's."""
    rng = np.random.default_rng(21)
    specs = [(f"k{i}", int(rng.integers(1, 9)) * 1000, float(rng.uniform(0.1, 3.0)),
              bool(i == 3)) for i in range(8)]
    clock = {"t": 0.0}
    evictors = {"port": CostAwareEvictor(20_000, clock=lambda: clock["t"]),
                "reference": RCostAwareEvictor(20_000, clock=lambda: clock["t"])}
    stores = {name: _FakeStore([_FakeEntry(*s) for s in specs]) for name in evictors}
    picks = {name: [] for name in evictors}
    for step in range(30):
        clock["t"] += float(rng.uniform(0.0, 2.0))
        key = f"k{int(rng.integers(0, 8))}"
        budget = int(rng.integers(5, 30)) * 1000
        for name, ev in evictors.items():
            ev.touch(key)
            ev.budget_bytes = budget
            picks[name].append(ev.enforce(stores[name], protect={"k0"}))
        if step % 7 == 6:                 # re-admit everything
            stores = {name: _FakeStore([_FakeEntry(*s) for s in specs]) for name in evictors}
    assert picks["port"] == picks["reference"]
    assert sum(len(p) for p in picks["port"]) > 5
    assert all("k0" not in p and "k3" not in p for p in picks["port"])


# -- the scheduler ------------------------------------------------------------------

def test_scheduler_flush_on_full_and_window():
    s = MicroBatchScheduler(max_batch=4, flush_window_s=10.0)
    k = "key"
    reqs = [s.make_request(k, SpreadEstimate((1,)), None, now=100.0) for _ in range(3)]
    assert [s.offer(r) for r in reqs] == [False, False, False]
    assert s.take_due(100.1) == []              # window open, not full
    assert s.next_flush_t() == 110.0
    r4 = s.make_request(k, SpreadEstimate((2,)), None, now=100.2)
    assert s.offer(r4) is True                  # full: flush now
    (bucket,) = s.take_due(100.2)
    assert [r.seq for r in bucket] == [r.seq for r in reqs + [r4]]
    assert s.depth() == 0
    r5 = s.make_request(k, SpreadEstimate((3,)), None, now=200.0)
    s.offer(r5)
    assert s.take_due(205.0) == []
    assert [[r5.seq]] == [[r.seq for r in b] for b in s.take_due(210.0)]


def test_scheduler_holds_and_requeue():
    s = MicroBatchScheduler(max_batch=8, flush_window_s=0.0)
    k1, k2 = "k1", "k2"
    a = s.make_request(k1, TopKSeeds(3), None, now=0.0)
    b = s.make_request(k2, TopKSeeds(3), None, now=0.0)
    s.offer(a), s.offer(b)
    s.hold(k1, "TopKSeeds")
    due = s.take_due(1.0)
    assert [r.key for bucket in due for r in bucket] == [k2]
    assert s.next_flush_t() is None             # a held bucket costs no wakeups
    s.requeue([b])
    s.hold(k2)                                  # qclass None parks every class
    assert s.take_due(2.0) == []
    s.release(k1, "TopKSeeds"), s.release(k2)
    assert {r.key for bucket in s.take_due(2.0) for r in bucket} == {k1, k2}
    s.offer(s.make_request(k1, TopKSeeds(3), None, now=0.0))
    s.offer(s.make_request(k1, SpreadEstimate((1,)), None, now=0.0))
    assert len(s.take_due(1.0)) == 2            # classes bucket apart


def test_scheduler_decisions_match_reference():
    """A random sequence of offers, holds, releases, requeues and flushes:
    the port's scheduler and the reference's take the same buckets, in the
    same order, and agree on depth, next flush and oldest wait."""
    rng = np.random.default_rng(31)
    scheds = {"port": MicroBatchScheduler(max_batch=5, flush_window_s=0.3),
              "reference": RScheduler(max_batch=5, flush_window_s=0.3)}
    queries = [TopKSeeds(3), SpreadEstimate((1, 2)), CoverageProbe((4,))]
    logs = {name: [] for name in scheds}
    t = 0.0
    for _ in range(300):
        t += float(rng.uniform(0.0, 0.1))
        op = int(rng.integers(0, 6))
        key = f"k{int(rng.integers(0, 3))}"
        q = queries[int(rng.integers(0, 3))]
        qclass = type(q).__name__ if rng.integers(0, 2) else None
        for name, s in scheds.items():
            if op <= 2:
                out = s.offer(s.make_request(key, q, None, now=t))
            elif op == 3:
                out = s.hold(key, qclass)
            elif op == 4:
                s.release(key, type(q).__name__)
                out = s.release(key)
            else:
                due = s.take_due(t)
                if due and len(due[0]) > 1:
                    s.requeue(due[0][1:])
                out = [[(r.seq, r.key, r.qclass) for r in b] for b in due]
            logs[name].append((out, s.depth(), s.next_flush_t(), s.oldest_wait_s(t)))
    assert logs["port"] == logs["reference"]
    left = {name: sorted(r.seq for b in s.take_all() for r in b) for name, s in scheds.items()}
    assert left["port"] == left["reference"]


def test_swap_drops_engine_topk_memo(graphs):
    """The engine's swap hook retires memoized top-k for the swapped key."""
    g1, _, cfg = graphs
    store = _store()
    engine = InfluenceEngine(store)
    key = engine.register(g1, cfg)
    engine(key, TopKSeeds(4))
    assert engine(key, TopKSeeds(4)).cache_hit
    shadow = store.shadow(key)
    shadow.rebuild(key)
    store.swap_entry(key, shadow.entry(key))
    assert (key, 4) not in engine._topk_memo
    assert not engine(key, TopKSeeds(4)).cache_hit


# -- failures reach futures -----------------------------------------------------------

def test_failed_bucket_and_failed_mutation_land_on_their_futures(graphs, monkeypatch):
    """A failing batch fails its bucket's futures (others are answered); a
    mutation whose shard-restricted repair fails (a CUDA error) fails its
    future with that error, and the entry stays as it was."""
    g1, _, cfg = graphs

    def broken(*a, **kw):
        raise RuntimeError("CUDA kernel sketch_cardinality failed to launch: cudaError 700")

    with AsyncInfluenceEngine(store=_store(), deadline_ms=10.0) as aeng:
        key = aeng.engine.register(g1, cfg)
        monkeypatch.setattr(TQ, "spread_estimates", broken)
        bad = aeng.submit(key, SpreadEstimate((1, 2)))
        good = aeng.submit(key, CoverageProbe((1, 2)))
        assert isinstance(bad.exception(WAIT), RuntimeError)
        assert good.result(WAIT).value["est"].shape == (2,)
        monkeypatch.undo()
        from repro_torch.partition import plan_partition

        entry = aeng.store.entry(key)
        aeng.store.attach_plan(key, plan_partition(entry.graph, 2, mu_s=1, x=entry.x,
                                                   device="cpu"))
        from repro_torch.partition import serial as T_serial

        def broken_repair(*a, **kw):
            raise RuntimeError("CUDA kernel bucket_propagate failed to launch: cudaError 700")

        monkeypatch.setattr(T_serial, "repair_plan_shards", broken_repair)
        fut = aeng.apply_delta_async(key, GraphDelta.make(add=([1], [2])), backend="auto")
        assert isinstance(fut.exception(WAIT), RuntimeError)
        aeng.drain(WAIT)
        assert aeng.store.entry(key) is entry and entry.version == 0


# -- the engine's SLO and the launcher ----------------------------------------------------

def test_engine_slo_breach_dumps_the_flight_ring(graphs, tmp_path):
    """Budgets from RunSpec.slo feed the watchdog; a breach dumps the flight
    ring (into tmp_path, through REPRO_TORCH_FLIGHT_DIR)."""
    g1, _, cfg = graphs
    engine = InfluenceEngine(spec=RunSpec(slo=(("SpreadEstimate", 1e-9),)), device="cpu")
    key = engine.register(g1, cfg)
    rec = flight.get_flight_recorder()
    saved = rec.dump_count
    rec.dump_count = 0
    try:
        for i in range(25):
            engine(key, SpreadEstimate((i, i + 1)))
    finally:
        rec.dump_count = saved
    summary = engine.slo_summary()
    assert summary["SpreadEstimate"]["in_breach"] and summary["_breach_count"] == 1
    assert any(p.name.startswith("flight_") for p in tmp_path.iterdir())
    with pytest.raises(ValueError):
        InfluenceEngine(_store(), spec=RunSpec())


def test_engine_makes_its_own_store_from_backend_and_spec(graphs):
    """Without a store, the engine builds one from ``spec``, whose
    ``backend`` chooses the build; the serial ring's matrix equals the
    single path's."""
    g1, _, cfg = graphs
    ring_spec = RunSpec(backend="serial", mu_v=2, mu_s=2)
    single = InfluenceEngine(device="cpu")
    ring = InfluenceEngine(spec=ring_spec, device="cpu")
    assert ring.store.spec.backend == "serial" and single.store.spec is None
    a = single.store.entry(single.register(g1, cfg)).matrix
    b = ring.store.entry(ring.register(g1, cfg)).matrix
    assert a.numpy().tobytes() == b.numpy().tobytes()
    with AsyncInfluenceEngine(spec=ring_spec, device="cpu") as aeng:
        assert aeng.store.spec.backend == "serial"
        assert aeng.store.device.type == "cpu" and aeng._mut_stream is None


ASYNC_LINE = re.compile(r"^async: deadline 50ms  e2e p99 [\d.]+ms  miss rate [\d.]+%  "
                        r"flushes \d+$", re.M)


def test_serve_async_prints_the_reference_async_line(capsys):
    from repro.launch import serve_im as R_serve
    from repro_torch.launch import serve_im as T_serve

    argv = ["--graph", "rmat:8", "--registers", "64", "--queries", "48", "--async"]
    want = R_serve.run(argv)
    ref_out = capsys.readouterr().out
    got = T_serve.run(argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    assert ASYNC_LINE.search(ref_out) and ASYNC_LINE.search(port_out), port_out
    assert set(got["admission"]) == set(want["admission"])
    assert got["admission"]["completed"] == want["admission"]["completed"] == 48
    assert set(got) == set(want)
    for key in ("num_queries", "cache_hits", "deduped", "by_backend"):
        assert got[key] == want[key], key
