"""The port's HTML report (``repro_torch.obs.report``) against the
reference's ``repro.obs.report``, on the CPU: byte-identical HTML for the
same inputs, section by section and for each section's empty state; the
port's tuning cache rendered (its work-item geometry too); and the
artifacts entry point over files a run leaves behind.

Inputs are made from seeds with numpy; the shard profiles are each
package's own ``MeasuredProfile`` built from the same arrays.
"""
import json

import numpy as np
import pytest

from repro.obs import report as R_report
from repro.obs.shardprof import MeasuredProfile as RefProfile
from repro_torch.obs import metrics, report, shardprof, trace
from repro_torch.obs.shardprof import MeasuredProfile
from repro_torch.tune import KernelConfig, TuningCache

SECTIONS = ("Runtime backends", "Phase breakdown", "Shard skew — measured", "Admission",
            "Kernel tuning", "SLO")


def _runtime(seed=0):
    rng = np.random.default_rng(seed)
    backends = {name: {"available": True, "cold_s": float(rng.random() * 5),
                       "seeds_per_s_cold": float(rng.random() * 20),
                       "warm_s": float(rng.random()), "seeds_per_s_warm": float(rng.random() * 90),
                       "store_build_s": float(rng.random()), "seeds_identical": True}
                for name in ("single", "serial")}
    backends["mesh"] = {"available": False, "reason": "one card"}
    return {"graph": "rmat:20", "n": 1_048_576, "m": 16_084_843, "k": 50,
            "backends": backends}


def _service(with_async=True, seed=1):
    rng = np.random.default_rng(seed)
    out = {"qps": 3110.4, "p50_ms": 0.82, "p99_ms": 311.3, "n": 1000,
           "device_vs_host": 1.7}
    if with_async:
        t = np.cumsum(rng.random(40) * 0.01)
        out["async"] = {"sustained_qps": 2936.0, "e2e_p99_ms": 331.9, "deadline_ms": 50,
                        "deadline_misses": 52, "deadline_miss_rate": 0.052,
                        "completed": 1000, "flushes": 4, "cross_entry_batches": 2,
                        "admission_stalls": 1, "budget_bytes": 738_000_000,
                        "resident_bytes": 671_000_000,
                        "queue_depth_timeline": [[float(a), int(b)] for a, b in
                                                 zip(t, rng.integers(0, 300, 40))]}
    return out


def _events(seed=2):
    rng = np.random.default_rng(seed)
    phases = trace.PHASES
    return [{"name": f"span{i}", "phase": phases[i % len(phases)], "ts_s": float(i),
             "dur_s": float(rng.random()), "depth": int(rng.integers(0, 2)), "attrs": {}}
            for i in range(30)]


def _metrics_rows():
    return [{"name": "partition.predicted_vs_measured_edge_imb", "kind": "gauge",
             "value": 1.0, "tags": {"strategy": "degree", "backend": "serial"}},
            {"name": "partition.predicted_vs_measured_bucket_imb", "kind": "gauge",
             "value": 2.7, "tags": {"strategy": "block", "backend": "serial"}},
            {"name": "store.evictions", "kind": "counter", "value": 6, "tags": {}},
            {"name": "store.evicted_rebuilds", "kind": "counter", "value": 5, "tags": {}},
            {"name": "store.swaps", "kind": "counter", "value": 3, "tags": {}},
            {"name": "store.swap_s", "kind": "histogram", "p99": 0.02, "mean": 0.01,
             "count": 3, "tags": {}}]


def _profiles(cls, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for phase in ("build", "fixpoint"):
        out.append(cls(backend="serial", phase=phase, strategy="degree", mu_v=4, mu_s=2,
                       sweeps=int(rng.integers(1, 9)), step_seconds=rng.random((4, 4)),
                       step_bytes=rng.integers(1, 1 << 30, (4, 4)), wall_s=float(rng.random()),
                       per_step_timed=phase == "build"))
    return out


def _slo():
    return {"spread": {"samples": 900, "window_p99_ms": 31.5, "budget_ms": 50.0,
                       "in_breach": False},
            "topk": {"samples": 50, "window_p99_ms": 331.9, "budget_ms": 100.0,
                     "in_breach": True},
            "probe": {"samples": 150, "window_p99_ms": 0.4, "budget_ms": None,
                      "in_breach": False},
            "_breach_count": 2}


def _tuning():
    """Entries both packages render alike: the reference's knobs."""
    return {
        "bucket_propagate|serial|cuda|wc|e16777216": {
            "config": {"local_sweeps": 1, "pad_mode": "global", "fuse_sweeps": False,
                       "lane_fill": 0, "edge_block": 0},
            "measurement": {"speedup": 1.04, "default_us": 1_300_000.5, "tuned_us": 1_250_000,
                            "tuned_gbps": 26.6, "frac_of_roof": 0.0079}},
        "fused_sweep|serial|cuda|lt|e8192": {
            "config": {"fuse_sweeps": True, "lane_fill": 256},
            "measurement": {"speedup": 0.98, "default_us": 7_470, "tuned_us": 7_470,
                            "tuned_gbps": 1000.25, "frac_of_roof": 0.3}},
        "sketch_propagate|single|ref|wc|e256": {"config": {"edge_block": 512,
                                                           "reg_tile": 128}},
    }


def _inputs(part):
    """The keyword arguments of one case: ``part`` names the stream given
    (the others stay empty)."""
    return {
        "tiles": lambda: {"runtime": _runtime(), "service": _service(False), "slo": _slo()},
        "backends": lambda: {"runtime": _runtime()},
        "phases": lambda: {"events": _events()},
        "skew": lambda: {"metrics_rows": _metrics_rows()},
        "admission": lambda: {"service": _service(), "metrics_rows": _metrics_rows()},
        "admission_no_timeline": lambda: {"service": dict(_service(), **{"async": {
            k: v for k, v in _service()["async"].items() if k != "queue_depth_timeline"}})},
        "tuning": lambda: {"tuning": _tuning()},
        "slo": lambda: {"slo": _slo()},
        "slo_no_budgets": lambda: {"slo": {"_breach_count": 0}},
        "empty": lambda: {},
        "all": lambda: {"runtime": _runtime(), "service": _service(), "events": _events(),
                        "metrics_rows": _metrics_rows(), "slo": _slo(),
                        "tuning": _tuning(), "title": "a <run> & more",
                        "generated": "NVIDIA H100 80GB HBM3, 700.00 W"},
    }[part]()


@pytest.mark.parametrize("part", ["tiles", "backends", "phases", "skew", "admission",
                                  "admission_no_timeline", "tuning", "slo", "slo_no_budgets",
                                  "empty", "all"])
def test_write_report_is_byte_identical_to_the_reference(tmp_path, part):
    kw = _inputs(part)
    mine = report.write_report(str(tmp_path / "port.html"), **kw)
    theirs = R_report.write_report(str(tmp_path / "ref.html"), **kw)
    page = (tmp_path / "port.html").read_bytes()
    assert mine == str(tmp_path / "port.html") and theirs == str(tmp_path / "ref.html")
    assert page == (tmp_path / "ref.html").read_bytes()
    for heading in SECTIONS[1:]:         # "Runtime backends" only with backends
        assert f"<h2>{heading}</h2>".encode() in page


@pytest.mark.parametrize("with_metrics", [False, True])
def test_shard_profiles_render_as_the_reference_renders_its_own(tmp_path, with_metrics):
    rows = _metrics_rows() if with_metrics else []
    report.write_report(str(tmp_path / "port.html"), profiles=_profiles(MeasuredProfile),
                        metrics_rows=rows)
    R_report.write_report(str(tmp_path / "ref.html"), profiles=_profiles(RefProfile),
                          metrics_rows=rows)
    page = (tmp_path / "port.html").read_text()
    assert page == (tmp_path / "ref.html").read_text()
    assert "per-shard relative load" in page and "no shard profiles captured" not in page


@pytest.mark.parametrize("name", ["_fmt", "_esc"])
@pytest.mark.parametrize("value", [0, 3, 12.5, 99.999, 1284, 12_900, 4.2e6, 7.5e9, -3e4,
                                   "x<y", None])
def test_formatting_helpers_match_reference(name, value):
    assert getattr(report, name)(value) == getattr(R_report, name)(value)


def test_the_port_s_geometry_is_labelled(tmp_path):
    cfg = KernelConfig(item_edges=512, item_warps=8, local_sweeps=1).to_dict()
    assert report._cfg_label(cfg) == "ie=512 iw=8 ls=1"
    assert report._cfg_label(KernelConfig().to_dict()) == "defaults"
    for theirs in (c["config"] for c in _tuning().values()):
        assert report._cfg_label(theirs) == R_report._cfg_label(theirs)
    path = tmp_path / "r.html"
    report.write_report(str(path), tuning={"sketch_propagate|single|cuda|wc|e8192": {
        "config": cfg, "measurement": {"speedup": 1.07, "default_us": 9547, "tuned_us": 8900,
                                       "tuned_gbps": 2121.0, "frac_of_roof": 0.633}}})
    page = path.read_text()
    assert "ie=512 iw=8 ls=1" in page and "1.07x" in page and "63.3%" in page


def test_report_from_artifacts(tmp_path, monkeypatch):
    """The artifacts entry point reads the BENCH files and the tuning cache
    a run leaves behind, and the live recorder, registry and profile ring:
    the same page as ``write_report`` of the same streams."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "BENCH_runtime.json").write_text(json.dumps(_runtime()))
    (tmp_path / "BENCH_service.json").write_text(json.dumps(_service()))
    cache = TuningCache(str(tmp_path / "TUNE_cache.json"))
    cache.put("sketch_propagate|single|cuda|wc|e8192", KernelConfig(item_edges=128),
              measurement={"speedup": 1.02, "default_us": 10, "tuned_us": 9.8,
                           "tuned_gbps": 1.0, "frac_of_roof": 0.001})
    cache.save()
    rec = trace.Recorder().start()
    out = report.write_report_from_artifacts(str(tmp_path / "a.html"), recorder=rec,
                                             generated="g")
    want = report.write_report(str(tmp_path / "b.html"), runtime=_runtime(),
                               service=_service(), events=rec.events(),
                               metrics_rows=metrics.registry().snapshot(),
                               profiles=shardprof.profiles(), tuning=cache.records(),
                               generated="g")
    assert (tmp_path / "a.html").read_text() == (tmp_path / "b.html").read_text()
    assert out.endswith("a.html") and want.endswith("b.html")
    assert "ie=128" in (tmp_path / "a.html").read_text()
    (tmp_path / "BENCH_runtime.json").write_text("{broken")
    report.write_report_from_artifacts(str(tmp_path / "c.html"), recorder=rec,
                                       tuning_json=str(tmp_path / "absent.json"))
    page = (tmp_path / "c.html").read_text()
    assert "no tuning cache captured" in page and "Runtime backends" not in page
