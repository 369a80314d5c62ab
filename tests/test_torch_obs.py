"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``) on the same inputs: histogram percentiles, JSONL
snapshots read across the packages, the SLO watchdog's breach sequence,
span nesting and the Chrome-trace schema, the flight ring's bound and dump,
the torch sync adapter that replaces ``jax.block_until_ready``, and the
serial ring's measured shard profiles (``obs.shardprof``) and their
predicted-vs-measured gauges."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import difuser as R_difuser
from repro.graphs import rmat_graph as ref_rmat
from repro.obs import flight as R_flight
from repro.obs import metrics as R_metrics
from repro.obs import shardprof as R_shardprof
from repro.obs import slo as R_slo
from repro.obs import trace as R_trace
from repro_torch.obs import flight as T_flight
from repro_torch.obs import metrics as T_metrics
from repro_torch.obs import shardprof as T_shardprof
from repro_torch.obs import slo as T_slo
from repro_torch.obs import trace as T_trace


def _latencies(seed=0, n=500):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(-6, 1.0, n), [0.0, 1e-10, 2.5, 1e-3]])


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_percentiles_match_reference(seed):
    r, t = R_metrics.Histogram(unit="s"), T_metrics.Histogram(unit="s")
    for v in _latencies(seed):
        r.observe(v)
        t.observe(v)
    assert t.summary() == r.summary()
    for q in (0, 50, 95, 99, 100):
        assert t.percentile(q) == r.percentile(q)


def _fill(reg, seed):
    reg.counter("engine.requests", query="SpreadEstimate").inc(7 + seed)
    reg.gauge("store.resident_bytes").set(1024.0 * (seed + 1))
    h = reg.histogram("engine.batch_latency_s", unit="s", query="TopKSeeds")
    for v in _latencies(seed, 64):
        h.observe(v)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_jsonl_snapshot_reads_across_packages(tmp_path, writer):
    """A snapshot written by either package merges into the other's registry
    and comes back equal, series for series."""
    mods = {"port": T_metrics, "reference": R_metrics}
    reader = "reference" if writer == "port" else "port"
    src = mods[writer].MetricsRegistry()
    _fill(src, 0)
    path = tmp_path / "m.jsonl"
    assert src.write_jsonl(str(path)) == 3
    back = mods[reader].MetricsRegistry.from_jsonl(str(path))
    assert list(back.snapshot()) == list(src.snapshot())
    # and merging a second process's snapshot adds the same way in both
    other = mods[writer].MetricsRegistry()
    _fill(other, 1)
    path2 = tmp_path / "m2.jsonl"
    other.write_jsonl(str(path2))
    both_src = mods[writer].MetricsRegistry.from_jsonl(str(path), str(path2))
    both_back = mods[reader].MetricsRegistry.from_jsonl(str(path), str(path2))
    assert list(both_back.snapshot()) == list(both_src.snapshot())


def test_slo_watchdog_breach_sequence_matches_reference():
    rng = np.random.default_rng(3)
    # calm, a slow excursion, recovery, a second excursion
    lat = np.concatenate([rng.uniform(0.001, 0.004, 40), rng.uniform(0.02, 0.05, 15),
                          rng.uniform(0.001, 0.004, 300), rng.uniform(0.03, 0.06, 10)])
    calls = {"port": [], "reference": []}
    dogs = {"port": T_slo.SLOWatchdog({"SpreadEstimate": 10.0, "TopKSeeds": 1e9},
                                      on_breach=lambda *a: calls["port"].append(a[:3])),
            "reference": R_slo.SLOWatchdog({"SpreadEstimate": 10.0, "TopKSeeds": 1e9},
                                           on_breach=lambda *a: calls["reference"].append(
                                               a[:3]))}
    edges = {name: [d.observe("SpreadEstimate", v) for v in lat] for name, d in dogs.items()}
    for name, d in dogs.items():
        for v in lat[:30]:
            d.observe("TopKSeeds", v)
        d.observe("Unbudgeted", 1.0)
    assert edges["port"] == edges["reference"]
    assert sum(edges["port"]) == 2
    assert calls["port"] == calls["reference"] and len(calls["port"]) == 2
    assert dogs["port"].summary() == dogs["reference"].summary()
    assert T_slo.SLOConfig.coerce({}) is None
    assert T_slo.SLOConfig.coerce([("b", 2), ("a", 1)]).budgets == (("a", 1.0), ("b", 2.0))


@pytest.fixture
def recorders():
    rt, rr = T_trace.get_recorder(), R_trace.get_recorder()
    rt.start()
    rr.start()
    yield rt, rr
    rt.stop()
    rr.stop()
    rt.clear()
    rr.clear()


def _nested(tr):
    with tr.span("outer", phase="build", n=3):
        with tr.span("inner"):               # inherits "build"
            with tr.span("leaf", phase="query", k=np.int64(4)):
                pass
        with tr.span("sibling", phase="repair") as sp:
            sp.annotate(rebuilt=False)
    with tr.span("top"):                     # no enclosing span: "other"
        pass

    @tr.traced("decorated", phase="select")
    def f():
        return 1
    f()


#: what the port's recorder adds to the reference's events: ids and parents
PORT_ONLY = ("id", "parent")


def _shape(trace_json):
    return [{k: ({a: b for a, b in v.items() if a not in PORT_ONLY} if k == "args" else v)
             for k, v in ev.items() if k not in ("ts", "dur")}
            for ev in trace_json["traceEvents"] if ev["name"] != "process_name"]


def test_span_nesting_phases_and_chrome_trace_match_reference(recorders):
    rt, rr = recorders
    _nested(T_trace)
    _nested(R_trace)
    strip = [{k: v for k, v in ev.items() if k not in ("ts_s", "dur_s") + PORT_ONLY}
             for ev in rt.events()]
    assert strip == [{k: v for k, v in ev.items() if k not in ("ts_s", "dur_s")}
                     for ev in rr.events()]
    by_name = {ev["name"]: ev for ev in rt.events()}
    assert by_name["inner"]["phase"] == "build" and by_name["inner"]["depth"] == 1
    assert by_name["leaf"]["depth"] == 2 and by_name["top"]["phase"] == "other"
    # each event names the span open around it, and the export carries both
    parent_of = {"outer": None, "inner": "outer", "leaf": "inner", "sibling": "outer",
                 "top": None, "decorated": None}
    for name, parent in parent_of.items():
        want = by_name[parent]["id"] if parent else None
        assert by_name[name]["parent"] == want, name
    assert len({ev["id"] for ev in rt.events()}) == len(rt.events())
    args = {e["name"]: e["args"] for e in rt.chrome_trace()["traceEvents"] if e["ph"] == "X"}
    assert all(args[n]["id"] == by_name[n]["id"] and args[n]["parent"] == by_name[n]["parent"]
               for n in parent_of)
    assert rt.phases_seen() == rr.phases_seen()
    assert _shape(rt.chrome_trace()) == _shape(rr.chrome_trace())
    assert rt.chrome_trace()["traceEvents"][0]["args"]["name"] == "repro_torch"
    assert rt.top_level_seconds() > 0


def test_disabled_span_is_the_null_singleton():
    assert not T_trace.tracing_enabled()
    assert T_trace.span("a") is T_trace.span("b", phase="query")
    with T_trace.span("x", timed=True) as sp:
        pass
    assert sp is not T_trace.span("a") and sp.duration_s >= 0.0


@pytest.fixture
def flight_in_tmp(tmp_path, monkeypatch):
    """The port's flight recorder dumping into ``tmp_path`` through its
    environment variable, with its settings restored afterwards."""
    rec = T_flight.get_flight_recorder()
    saved = (rec._ring.maxlen, rec.max_dumps, rec.dump_count, list(rec.dumps), rec.out_dir)
    monkeypatch.setenv(T_flight.ENV_DIR, str(tmp_path))
    rec.out_dir = None
    rec.dump_count = 0
    yield rec
    T_flight.configure(capacity=saved[0], max_dumps=saved[1])
    rec.dump_count, rec.dumps, rec.out_dir = saved[2], saved[3], saved[4]


def test_flight_ring_bound_and_dump(flight_in_tmp, tmp_path):
    rec = flight_in_tmp
    T_flight.configure(capacity=16)
    for i in range(40):
        with T_trace.span(f"batch{i}", phase="query", timed=True):
            pass
    assert len(rec) == 16
    assert [ev["name"] for ev in rec.events()] == [f"batch{i}" for i in range(24, 40)]
    T_metrics.counter("flight.test_events").inc(3)
    path = T_flight.dump("slo-breach test")
    assert path is not None and path.startswith(str(tmp_path))
    dumped = json.loads(open(path).read())
    assert dumped["metadata"]["reason"] == "slo-breach test"
    assert dumped["metadata"]["spans"] == 16
    assert dumped["metadata"]["counter_deltas"]["flight.test_events"] >= 3
    names = [ev["name"] for ev in dumped["traceEvents"] if ev["ph"] == "X"]
    assert names == [f"batch{i}" for i in range(24, 40)]
    # the reference's dump of the same ring has the same layout
    ref = R_flight.FlightRecorder(capacity=16)
    for ev in rec.events():
        ref._ring.append(ev)
    assert _shape(ref.chrome_trace("slo-breach test"))[:-1] == _shape(dumped)[:-1]
    # rate limit
    T_flight.configure(max_dumps=rec.dump_count)
    assert T_flight.dump("over the limit") is None


@dataclasses.dataclass
class _Holder:
    a: object
    b: object = None


class _FakeCuda:
    """Stands for a CUDA tensor in the walk (``is_cuda`` and ``device``)."""

    is_cuda = True

    def __init__(self, device):
        self.device = device


def test_sync_adapter_is_a_no_op_on_cpu_values():
    t = torch.arange(4)
    nested = (t, [np.zeros(3), {"k": (t, 1.5)}], _Holder(t, _Holder(np.ones(2))))
    for v in (t, nested, _Holder(t), np.zeros(2), None, "x"):
        assert T_trace._block_until_ready(v) is v
    devs = set()
    T_trace._cuda_devices(nested, devs, set())
    assert devs == set()


def test_sync_adapter_syncs_each_current_stream_once(monkeypatch):
    synced = []

    class _Stream:
        def __init__(self, dev):
            self.dev = dev

        def synchronize(self):
            synced.append(self.dev)

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream(dev))
    value = (_FakeCuda("cuda:0"), [{"x": _FakeCuda("cuda:1")}],
             _Holder(_FakeCuda("cuda:0"), (torch.zeros(2),)))
    with T_trace.span("s", timed=True, sync=value[0]) as sp:
        sp.sync(value)
    assert sorted(synced) == ["cuda:0", "cuda:1"]


def test_sync_adapter_does_not_swallow_a_cuda_error(monkeypatch):
    class _Stream:
        def synchronize(self):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    seen = []
    T_trace.add_span_listener(seen.append)
    try:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            with T_trace.span("kernel", timed=True) as sp:
                sp.sync(_Holder(_FakeCuda("cuda:0")))
    finally:
        T_trace.remove_span_listener(seen.append)
    assert [s.name for s in seen] == ["kernel"]      # the span still closed


# -- the serial ring's measured shard profiles --------------------------------------------

@pytest.fixture
def shard_profiling():
    """Profile capture on in both packages, each ring cleared, the switches
    restored afterwards."""
    saved = T_shardprof.enabled(), R_shardprof.enabled()
    for mod in (T_shardprof, R_shardprof):
        mod.clear()
        mod.set_enabled(True)
    try:
        yield
    finally:
        for mod, flag in zip((T_shardprof, R_shardprof), saved):
            mod.set_enabled(flag)
            mod.clear()


def _skewed_pair():
    kw = dict(edge_factor=8, a=0.65, b=0.15, c=0.15, seed=3, setting="w1")
    from repro_torch.graphs import rmat_graph as port_rmat

    return ref_rmat(8, **kw), port_rmat(8, **kw)


def _serial_profiles(strategy):
    """The port's and the reference's build profile of one serial run
    (4 x 1 grid, J = 64, K = 2)."""
    from repro.partition.serial import _find_seeds_ring_serial
    from repro_torch.core.difuser import DiFuserConfig
    from repro_torch.partition import find_seeds_ring_serial

    rg, tg = _skewed_pair()
    res, _ = find_seeds_ring_serial(tg, 2, DiFuserConfig(num_registers=64, seed=0), mu_v=4,
                                    mu_s=1, strategy=strategy, device="cpu")
    r_res, _ = _find_seeds_ring_serial(rg, 2, R_difuser.DiFuserConfig(num_registers=64, seed=0),
                                       mu_v=4, mu_s=1, strategy=strategy)
    np.testing.assert_array_equal(res.seeds, r_res.seeds)
    prof, r_prof = T_shardprof.last_profile(), R_shardprof.last_profile()
    assert prof is not None and r_prof is not None
    return res, prof, r_prof


def test_measured_profile_degree_beats_block_on_skewed_rmat(shard_profiling):
    res_blk, blk, r_blk = _serial_profiles("block")
    res_deg, deg, r_deg = _serial_profiles("degree")
    assert np.array_equal(res_blk.seeds, res_deg.seeds)
    # the bytes and sweeps are the reference's exactly (same buckets, same sweeps)
    for got, want in ((blk, r_blk), (deg, r_deg)):
        np.testing.assert_array_equal(got.step_bytes, want.step_bytes)
        assert (got.sweeps, got.phase, got.backend, got.strategy) == (
            want.sweeps, want.phase, want.backend, want.strategy)
    # the measured byte skew separates the planners
    assert blk.bytes_imbalance() > 1.2
    assert deg.bytes_imbalance() < blk.bytes_imbalance() * 0.8
    # each bucket merge is timed (the host clock on the CPU)
    assert blk.per_step_timed and deg.per_step_timed
    assert blk.phase == "fixpoint" and blk.backend == "serial"
    assert blk.step_seconds.shape == (4, 4)
    assert float(blk.step_seconds.sum()) > 0.0 and int(blk.step_bytes.sum()) > 0
    table = blk.skew_table()
    assert "bytes_imb" in table
    assert sum(line.lstrip().startswith(tuple("0123")) for line in table.splitlines()) == 4
    assert blk.summary()["shard_bytes"] == r_blk.summary()["shard_bytes"]


def test_predicted_vs_measured_gauges_published(shard_profiling):
    _serial_profiles("block")
    snap = {(rec["name"], tuple(sorted(rec.get("tags", {}).items())))
            for rec in T_metrics.registry().snapshot()}
    labels = (("backend", "serial"), ("strategy", "block"))
    for name in ("partition.measured_edge_imb", "partition.measured_time_imb",
                 "partition.achieved_gbps", "partition.predicted_vs_measured_edge_imb",
                 "partition.predicted_vs_measured_bucket_imb"):
        assert (name, labels) in snap, f"missing gauge {name}"
    ratio = T_metrics.registry().gauge("partition.predicted_vs_measured_edge_imb",
                                       backend="serial", strategy="block").value
    r_ratio = R_metrics.registry().gauge("partition.predicted_vs_measured_edge_imb",
                                         backend="serial", strategy="block").value
    # measured bytes follow the planner's per-edge counts: the ratio is ~1,
    # and the reference's to float rounding
    assert ratio == pytest.approx(1.0, rel=0.05)
    assert ratio == pytest.approx(r_ratio, rel=1e-12)


def test_profile_ring_is_bounded(shard_profiling):
    for _ in range(80):
        prof = T_shardprof.ShardProfiler(2, 1, backend="serial", phase="build")
        prof.record(0, 0, 0.001, 100)
        T_shardprof.publish(prof.finish(wall_s=0.01))
    assert len(T_shardprof.profiles()) == 64
    assert T_shardprof.bucket_bytes(3, 16) == R_shardprof.bucket_bytes(3, 16)


def test_profile_capture_off_records_nothing(shard_profiling):
    """With capture off the ring state gets no profiler, so no merge is timed."""
    T_shardprof.set_enabled(False)
    from repro_torch.core.difuser import DiFuserConfig
    from repro_torch.partition import build_matrix_ring_serial

    _, tg = _skewed_pair()
    cfg = DiFuserConfig(num_registers=64, seed=0)
    g = tg.sorted_by_dst()
    build_matrix_ring_serial(g, cfg, mu_v=4, device="cpu")
    assert T_shardprof.last_profile() is None
