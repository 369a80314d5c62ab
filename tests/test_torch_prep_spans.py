"""The two paths' phase timings are their spans' durations, on the CPU: the
single path's prep split into its four parts, the rounds' visited count,
the spans' parents, and the spans mirrored onto ``torch.profiler``'s clock
as ``record_function`` ranges while the recorder is on (and only then)."""
import ast
import sys
import weakref
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_threads import two_torch_threads  # noqa: F401  (autouse)
from repro_torch.core import difuser
from repro_torch.graphs import rmat_graph
from repro_torch.obs import trace
from repro_torch.partition import serial

ROOT = Path(__file__).resolve().parents[1]
K = 4
PREP_PARTS = ("sort_s", "lower_s", "upload_s", "worklists_s")
#: per path: its stats keys, the prep span and its children, the round's
#: children (the rebuild only on rebuild rounds)
PATHS = {
    "single": dict(keys=("prep_s",) + PREP_PARTS + ("build_s", "rounds_s", "visited_s"),
                   prep="single.prep",
                   prep_children={"single.sort_by_dst", "single.lower", "single.upload",
                                  "single.work_lists"},
                   round_children=("single.select", "single.cascade_fixpoint",
                                   "single.count_visited"),
                   rebuild="single.rebuild"),
    "serial": dict(keys=("sort_s", "sample_s", "plan_s", "buckets_s", "state_s", "build_s",
                         "rounds_s", "visited_s"),
                   prep=None, prep_children=set(),
                   round_children=("serial.select", "serial.cascade_fixpoint",
                                   "serial.visited_count"),
                   rebuild="serial.rebuild"),
}


def _run(path: str, model: str = "wc"):
    g = rmat_graph(7, seed=5, setting="w1")
    cfg = difuser.DiFuserConfig(num_registers=32, seed=1, model=model)
    if path == "single":
        return difuser.find_seeds(g, K, cfg, device="cpu")
    res, _ = serial.find_seeds_ring_serial(g, K, cfg, strategy="degree", device="cpu")
    return res


@pytest.fixture
def recorder():
    rec = trace.get_recorder()
    rec.start()
    yield rec
    rec.stop()
    rec.clear()


@pytest.mark.parametrize("model", ["wc", "lt"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_stats_carry_every_phase(path, model):
    st = _run(path, model).stats
    for key in PATHS[path]["keys"]:
        assert st[key] >= 0.0, key
    if path == "single":
        assert sum(st[key] for key in PREP_PARTS) <= st["prep_s"]
    assert st["visited_s"] <= st["rounds_s"]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_name_their_parents(path, recorder):
    want = PATHS[path]
    res = _run(path)
    events = recorder.events()
    by_id = {ev["id"]: ev for ev in events}
    if want["prep"] is not None:
        (prep,) = [ev for ev in events if ev["name"] == want["prep"]]
        children = {ev["name"] for ev in events if ev["parent"] == prep["id"]}
        assert children == want["prep_children"]
        # the four parts lie within the prep
        for ev in events:
            if ev["parent"] == prep["id"]:
                assert ev["dur_s"] <= prep["dur_s"]
        assert {"edges", "bytes"} <= set(next(ev for ev in events if ev["name"]
                                              == "single.upload")["attrs"])
        assert {"edges", "bytes"} <= set(next(ev for ev in events if ev["name"]
                                              == "single.lower")["attrs"])
    rounds = sorted((ev for ev in events if ev["name"] == f"{path}.round"),
                    key=lambda ev: ev["attrs"]["round"])
    assert len(rounds) == K
    for i, rnd in enumerate(rounds):
        children = [ev["name"] for ev in sorted(events, key=lambda ev: ev["ts_s"])
                    if ev["parent"] == rnd["id"]]
        expected = list(want["round_children"])
        if res.rebuilds[i]:
            expected.append(want["rebuild"])
        assert children == expected, (i, children)
        assert by_id[rnd["parent"]]["name"] == f"{path}.seed_rounds"
    visited = [ev for ev in events if ev["name"] == want["round_children"][-1]]
    assert sum(ev["dur_s"] for ev in visited) == pytest.approx(res.stats["visited_s"])


def _host_ranges(prof, names):
    """The profiler's host events whose name is one of ``names``, by name,
    each ``(start_us, end_us)`` in start order."""
    out = {}
    for evt in prof.events():
        if evt.name in names:
            out.setdefault(evt.name, []).append((evt.time_range.start, evt.time_range.end))
    return {name: sorted(v) for name, v in out.items()}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_are_profiler_ranges_while_recording(path, recorder):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(path)
    events = recorder.events()
    names = {ev["name"] for ev in events}
    ranges = _host_ranges(prof, names)
    # every recorded span is one range under its own name, on the profiler's clock
    for name in names:
        recorded = sorted(ev["ts_s"] for ev in events if ev["name"] == name)
        assert len(ranges.get(name, ())) == len(recorded), name
    at = {}
    for name in names:
        for ev, rng in zip(sorted((ev for ev in events if ev["name"] == name),
                                  key=lambda ev: ev["ts_s"]), ranges[name]):
            at[ev["id"]] = rng
    nested = 0
    for ev in events:
        if ev["parent"] is not None:
            (a, b), (pa, pb) = at[ev["id"]], at[ev["parent"]]
            assert pa <= a and b <= pb, (ev["name"], (a, b), (pa, pb))
            nested += 1
    assert nested > K


@pytest.mark.parametrize("path", sorted(PATHS))
def test_no_profiler_range_with_the_recorder_off(path):
    assert not trace.tracing_enabled()
    assert trace.span("a") is trace._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("probe.null"), trace.span("probe.timed", timed=True):
            torch.zeros(4).sum()
        _run(path)
    seen = {evt.name for evt in prof.events()}
    assert not {name for name in seen if name.startswith(("single.", "serial.", "probe."))}
    assert trace.get_recorder().events() == []


@pytest.mark.parametrize("recording", [False, True])
def test_a_finished_span_keeps_no_output_alive(recording):
    """A timed span's synced outputs are released at its exit, so a span
    kept for its duration holds no device matrix through later phases."""
    rec = trace.get_recorder()
    if recording:
        rec.start()
    try:
        t = torch.zeros(4)
        ref = weakref.ref(t)
        with trace.span("probe.output", timed=True) as sp:
            sp.sync(t)
        del t
        assert ref() is None and sp.duration_s >= 0.0
    finally:
        rec.stop()
        rec.clear()


def test_trace_module_imports_the_standard_library_only():
    tree = ast.parse((ROOT / "src/repro_torch/obs/trace.py").read_text())
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top.add(node.module.split(".")[0])
    assert top and top <= set(sys.stdlib_module_names) | {"__future__"}, top
