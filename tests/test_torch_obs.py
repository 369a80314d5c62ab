"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``) on the same inputs: histogram percentiles, JSONL
snapshots read across the packages, the SLO watchdog's breach sequence,
span nesting and the Chrome-trace schema, the flight ring's bound and dump,
and the torch sync adapter that replaces ``jax.block_until_ready``."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.obs import flight as R_flight
from repro.obs import metrics as R_metrics
from repro.obs import slo as R_slo
from repro.obs import trace as R_trace
from repro_torch.obs import flight as T_flight
from repro_torch.obs import metrics as T_metrics
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


def _shape(trace_json):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur")}
            for ev in trace_json["traceEvents"] if ev["name"] != "process_name"]


def test_span_nesting_phases_and_chrome_trace_match_reference(recorders):
    rt, rr = recorders
    _nested(T_trace)
    _nested(R_trace)
    strip = [{k: v for k, v in ev.items() if k not in ("ts_s", "dur_s")}
             for ev in rt.events()]
    assert strip == [{k: v for k, v in ev.items() if k not in ("ts_s", "dur_s")}
                     for ev in rr.events()]
    by_name = {ev["name"]: ev for ev in rt.events()}
    assert by_name["inner"]["phase"] == "build" and by_name["inner"]["depth"] == 1
    assert by_name["leaf"]["depth"] == 2 and by_name["top"]["phase"] == "other"
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
