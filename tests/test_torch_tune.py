"""The port's measured kernel tuning (``repro_torch.tune``) against the
reference's ``repro.tune``, on the CPU: the cache's keys, schema and files
(each package loads the other's), the candidate seeding from the same
``PlanStats``/``MeasuredProfile`` values, the spec overrides, the
``resolve_spec`` modes with their counters, the work-item geometry the port
tunes (``kernels.edges.work_list``, ``kernels.build``'s block-shape
libraries), the launchers' ``--tuning``, and the contract the tuner rests on:
seeds and matrices byte-equal across ``off``, ``cached`` and ``auto``, and
equal to the reference's untuned ``impl="ref"`` run. A ``cuda``-marked case
holds each sweep kernel at every geometry against its plain version.

Inputs (graphs, stats, profiles) are made from seeds with numpy and handed to
both packages.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import two_torch_threads  # noqa: F401  (autouse)
from repro.graphs import rmat_graph as ref_rmat
from repro.obs.shardprof import MeasuredProfile as RefProfile
from repro.partition.cost import PlanStats as RefPlanStats
from repro.runtime import RunSpec as RSpec
from repro.runtime import run as r_run
from repro.tune import autotuner as R_autotuner
from repro.tune import cache as R_cache
from repro.tune import config as R_config
from repro_torch.graphs import rmat_graph as port_rmat
from repro_torch.kernels import build, ops
from repro_torch.kernels.edges import (CHUNK, ITEM_WARPS, EdgeOperands, ItemGeometry,
                                       group_rows, with_work, work_list)
from repro_torch.obs import metrics
from repro_torch.obs.shardprof import MeasuredProfile
from repro_torch.partition.cost import PlanStats
from repro_torch.runtime import InfluenceSession, RunSpec, run
from repro_torch.runtime.base import apply_tuning
from repro_torch.tune import (CACHE_ENV, DEFAULT_CACHE_PATH, KernelConfig, TuningCache,
                              cache_key, default_cache, default_config, families_for,
                              fused_candidates, reset_default_cache, resolve_spec,
                              schedule_candidates, size_bucket, spec_overrides,
                              sweep_candidates)
from repro_torch.tune.autotuner import sweep_call, sweep_operands
from repro_torch.tune.cache import CACHE_VERSION

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def isolated_cache(tmp_path, monkeypatch):
    """The process cache at a file under ``tmp_path``."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv(CACHE_ENV, str(path))
    reset_default_cache()
    yield path
    reset_default_cache()


def _graphs(scale=6, seed=7):
    return (ref_rmat(scale, edge_factor=4, seed=seed, setting="w1"),
            port_rmat(scale, edge_factor=4, seed=seed, setting="w1"))


# ------------------------------------------------------------- the cache ----

@pytest.mark.parametrize("num_edges", [0, 1, 255, 256, 257, 4097, 5000, 16_084_843])
@pytest.mark.parametrize("family,backend,impl,model", [
    ("sketch_propagate", "single", "cuda", "wc"),
    ("bucket_propagate", "serial", "cpu", "ic:0.1"),
    ("fused_sweep", "serial", "ref", "lt")])
def test_size_bucket_and_cache_key_match_reference(num_edges, family, backend, impl, model):
    assert size_bucket(num_edges) == R_cache.size_bucket(num_edges)
    kw = dict(backend=backend, impl=impl, model=model, num_edges=num_edges)
    assert cache_key(family, **kw) == R_cache.cache_key(family, **kw)


def test_cache_constants_match_reference():
    assert (CACHE_VERSION, DEFAULT_CACHE_PATH, CACHE_ENV) == (
        R_cache.CACHE_VERSION, R_cache.DEFAULT_CACHE_PATH, R_cache.CACHE_ENV)


def test_cache_round_trip(tmp_path):
    path = str(tmp_path / "tune.json")
    c = TuningCache(path)
    cfg = KernelConfig(item_edges=512, item_warps=8, local_sweeps=1)
    c.put("k1", cfg, measurement={"speedup": 1.2})
    c.save()
    c2 = TuningCache(path)
    assert c2.lookup("k1") == cfg
    assert c2.record("k1")["measurement"]["speedup"] == 1.2
    assert len(c2) == 1 and list(c2.records()) == ["k1"]
    assert c2.lookup("absent") is None and c2.record("absent") is None


def test_cache_corrupt_and_version_mismatch(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert len(TuningCache(str(bad))) == 0
    wrong = tmp_path / "wrong.json"
    wrong.write_text(json.dumps({"version": CACHE_VERSION + 1,
                                 "entries": {"k": {"config": {}}}}))
    assert TuningCache(str(wrong)).lookup("k") is None
    listed = tmp_path / "list.json"
    listed.write_text("[1, 2]")
    assert len(TuningCache(str(listed))) == 0


def test_default_cache_env_override(tmp_path, monkeypatch):
    p = str(tmp_path / "env.json")
    monkeypatch.setenv(CACHE_ENV, p)
    reset_default_cache()
    try:
        assert default_cache().path == p and default_cache() is default_cache()
        monkeypatch.setenv(CACHE_ENV, "")          # persistence off
        assert default_cache().path is None
        default_cache().put("k", KernelConfig())
        default_cache().save()
        assert not tmp_path.joinpath("env.json").exists()
        monkeypatch.delenv(CACHE_ENV)
        assert default_cache().path == DEFAULT_CACHE_PATH
    finally:
        reset_default_cache()


def test_cache_files_cross_packages(tmp_path):
    """A file the port writes loads in the reference and the other way
    round; the fields both packages have are equal, the others dropped."""
    port_path, ref_path = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    port = TuningCache(port_path)
    port.put("bucket_propagate|serial|cuda|wc|e8192",
             KernelConfig(local_sweeps=1, pad_mode="global"), measurement={"speedup": 1.1})
    port.put("sketch_propagate|single|cuda|wc|e8192",
             KernelConfig(item_edges=128, item_warps=8, fuse_sweeps=True, lane_fill=256))
    port.save()
    ref = R_cache.TuningCache(port_path)
    assert len(ref) == 2
    got = ref.lookup("bucket_propagate|serial|cuda|wc|e8192")
    assert (got.local_sweeps, got.pad_mode, got.fuse_sweeps, got.lane_fill) == (1, "global",
                                                                                False, 0)
    assert ref.record("bucket_propagate|serial|cuda|wc|e8192")["measurement"] == {
        "speedup": 1.1}
    got = ref.lookup("sketch_propagate|single|cuda|wc|e8192")
    assert (got.edge_block, got.reg_tile, got.fuse_sweeps, got.lane_fill) == (0, 0, True, 256)

    theirs = R_cache.TuningCache(ref_path)
    theirs.put("sketch_propagate|single|ref|wc|e8192",
               R_config.KernelConfig(edge_block=256, local_sweeps=2, pad_mode="global",
                                     fuse_sweeps=True, lane_fill=512),
               measurement={"speedup": 1.3})
    theirs.save()
    mine = TuningCache(ref_path)
    assert mine.lookup("sketch_propagate|single|ref|wc|e8192") == KernelConfig(
        local_sweeps=2, pad_mode="global", fuse_sweeps=True, lane_fill=512)
    assert mine.records() == theirs.records()


# -------------------------------------------------------- the candidates ----

def _stats(cls, ring_bytes, waste):
    return cls(source="predicted", strategy="degree", mu_v=2, mu_s=2,
               edges_per_shard=np.array([10, 12], np.int64), edge_imbalance=1.1,
               bucket_imbalance=1.2, pad_waste_frac=waste, ring_bytes_per_sweep=ring_bytes)


def _profile(cls, step_total, sweeps):
    rng = np.random.default_rng(step_total % 1000)
    share = rng.dirichlet(np.ones(4)).reshape(2, 2)
    return cls(backend="serial", phase="build", strategy="degree", mu_v=2, mu_s=2,
               sweeps=sweeps, step_seconds=rng.random((2, 2)),
               step_bytes=np.round(share * step_total).astype(np.int64), wall_s=0.5,
               per_step_timed=True)


# (ring bytes a sweep, bucket bytes a sweep * sweeps, sweeps): comm
# fractions None (no stats, no ring bytes, no profile), 1%, 10% and 40%
COMM = [(None, None, 0), (0, 4_000_000, 4), (1000, None, 0), (1000, 396_000, 4),
        (1000, 36_000, 4), (1000, 1_500, 1)]


@pytest.mark.parametrize("model", ["wc", "lt"])
@pytest.mark.parametrize("num_regs", [64, 300, 1024])
@pytest.mark.parametrize("waste", [0.05, 0.3])
@pytest.mark.parametrize("ring_bytes,step_total,sweeps", COMM)
def test_schedule_and_fused_candidates_match_reference(ring_bytes, step_total, sweeps,
                                                       waste, num_regs, model):
    if ring_bytes is None:
        mine = theirs = (None, None)
    else:
        mine = (_stats(PlanStats, ring_bytes, waste),
                None if step_total is None else _profile(MeasuredProfile, step_total, sweeps))
        theirs = (_stats(RefPlanStats, ring_bytes, waste),
                  None if step_total is None else _profile(RefProfile, step_total, sweeps))
    for pad_mode in ("step", "global"):
        got = schedule_candidates(*mine, pad_mode=pad_mode)
        want = R_config.schedule_candidates(*theirs, pad_mode=pad_mode)
        assert [(c.local_sweeps, c.pad_mode) for c in got] == [
            (c.local_sweeps, c.pad_mode) for c in want]
    got = fused_candidates(*mine, model=model, num_regs=num_regs)
    want = R_config.fused_candidates(*theirs, model=model, num_regs=num_regs)
    assert [(c.fuse_sweeps, c.lane_fill) for c in got] == [
        (c.fuse_sweeps, c.lane_fill) for c in want]


@pytest.mark.parametrize("num_edges", [1, 50, 100, 256, 700, 5000, 1 << 24])
def test_sweep_candidates_clamp_dedupe_and_put_the_default_first(num_edges):
    cands = sweep_candidates(num_edges)
    assert cands[0] == KernelConfig() == default_config("sketch_propagate")
    geos = [c.geometry() for c in cands]
    geos[0] = (min(CHUNK, num_edges), ITEM_WARPS)
    assert len(set(geos)) == len(geos)                       # no two alike
    assert all(e <= max(num_edges, 1) for e, _ in geos)     # clamped
    assert {w for _, w in geos} == set(build.ITEM_WARPS)
    want = {(min(e, num_edges), w) for e in (64, 128, 256, 512, 1024)
            for w in build.ITEM_WARPS}
    assert set(geos) == want
    assert all(c.local_sweeps == 0 and not c.fuse_sweeps for c in cands)


def test_kernel_config_ignores_unknown_fields_both_ways():
    ref_dict = R_config.KernelConfig(edge_block=512, reg_tile=128, local_sweeps=1).to_dict()
    assert KernelConfig.from_dict(ref_dict) == KernelConfig(local_sweeps=1)
    port_dict = KernelConfig(item_edges=64, item_warps=2, lane_fill=8).to_dict()
    assert R_config.KernelConfig.from_dict(port_dict) == R_config.KernelConfig(lane_fill=8)
    assert KernelConfig().geometry() == (CHUNK, ITEM_WARPS)
    assert KernelConfig(item_edges=64, item_warps=8).geometry() == (64, 8)


def test_families_and_defaults_match_reference():
    from repro_torch import tune

    assert tune.KERNEL_FAMILIES == R_config.KERNEL_FAMILIES
    assert tune.SWEEP_FAMILIES == R_config.SWEEP_FAMILIES
    assert set(tune.DEFAULT_CONFIGS) == set(R_config.DEFAULT_CONFIGS)
    assert set(tune.__all__) == set(__import__("repro.tune", fromlist=["x"]).__all__)


@pytest.mark.parametrize("family", ["bucket_propagate", "fused_sweep", "fused_sample"])
def test_spec_overrides_of_the_ring_match_reference(family):
    spec, rspec = RunSpec(), RSpec()
    for kw in ({}, {"local_sweeps": 2, "pad_mode": "global"},
               {"fuse_sweeps": True, "lane_fill": 256}, {"local_sweeps": 1, "lane_fill": 8}):
        got = spec_overrides(family, KernelConfig(**kw), spec)
        assert got == R_config.spec_overrides(family, R_config.KernelConfig(**kw), rspec)
        assert RunSpec().with_(**got)                      # fields the spec has


def test_spec_overrides_of_the_sweeps():
    spec = RunSpec()
    cfg = KernelConfig(item_edges=512, item_warps=8)
    assert spec_overrides("sketch_propagate", cfg, spec) == {"item_edges": 512,
                                                             "item_warps": 8}
    assert spec_overrides("cascade_step", cfg, spec) == {"cascade_item_edges": 512}
    assert spec_overrides("sketch_propagate", KernelConfig(), spec) == {
        "item_edges": 0, "item_warps": 0}
    tuned = spec.with_(item_edges=512, cascade_item_edges=64, item_warps=8)
    assert tuned.item_geometry() == {"propagate": ItemGeometry(512, 8),
                                     "cascade": ItemGeometry(64, 8)}
    assert RunSpec().item_geometry() == {"propagate": ItemGeometry(), "cascade": ItemGeometry()}
    # none of the tuning fields is a result field
    assert tuned.difuser_config() == spec.difuser_config()
    assert spec.with_(tuning="auto").difuser_config() == spec.difuser_config()


@pytest.mark.parametrize("backend", ["single", "serial", "mesh", "nope"])
@pytest.mark.parametrize("mu_v,mu_s", [(1, 1), (2, 1), (2, 2)])
def test_families_for_matches_reference(backend, mu_v, mu_s):
    assert families_for(RunSpec(mu_v=mu_v, mu_s=mu_s), backend) == R_autotuner.families_for(
        RSpec(mu_v=mu_v, mu_s=mu_s), backend)


# -------------------------------------------------------- resolve_spec ----

def test_resolve_spec_off_is_identity():
    _, g = _graphs()
    spec = RunSpec(num_registers=64, seed=1)
    assert resolve_spec(g, spec, backend="single", device="cpu") is spec
    assert apply_tuning(g, spec, "single", device="cpu") is spec
    auto = spec.with_(tuning="auto")
    assert resolve_spec(None, auto, backend="single", device="cpu") is auto


def test_resolve_spec_rejects_unknown_mode():
    _, g = _graphs()
    with pytest.raises(ValueError, match="banana"):
        resolve_spec(g, RunSpec(num_registers=64, tuning="banana"), backend="single",
                     device="cpu")


def _count(name, family, backend):
    return metrics.registry().counter(name, family=family, backend=backend).value


def test_resolve_spec_cached_hit_and_miss():
    _, g = _graphs()
    spec = RunSpec(num_registers=64, seed=1, tuning="cached")
    cache = TuningCache(None)                              # in memory, cold
    miss0 = _count("tune.cache_miss", "sketch_propagate", "single")
    hit0 = _count("tune.cache_hit", "sketch_propagate", "single")
    out = resolve_spec(g, spec, backend="single", cache=cache, device="cpu")
    assert out is spec                                     # misses keep the spec
    assert _count("tune.cache_miss", "sketch_propagate", "single") == miss0 + 1
    key = cache_key("sketch_propagate", backend="single", impl="cpu", model=spec.model,
                    num_edges=int(g.m))
    cache.put(key, KernelConfig(item_edges=128, item_warps=8))
    out = resolve_spec(g, spec, backend="single", cache=cache, device="cpu")
    assert (out.item_edges, out.item_warps, out.cascade_item_edges) == (128, 8, 0)
    assert out.tuning == "cached"
    assert _count("tune.cache_hit", "sketch_propagate", "single") == hit0 + 1
    # the key's impl slot is the device type: a card's winner is no CPU hit
    card = TuningCache(None)
    card.put(key.replace("|cpu|", "|cuda|"), KernelConfig(item_edges=128, item_warps=8))
    assert resolve_spec(g, spec, backend="single", cache=card, device="cpu") is spec


def test_resolve_spec_auto_measures_on_the_cpu_and_persists(tmp_path):
    _, g = _graphs()
    spec = RunSpec(num_registers=64, seed=1, tuning="auto")
    path = str(tmp_path / "tune.json")
    cache = TuningCache(path)
    trials0 = _count("tune.trials", "sketch_propagate", "single")
    out = resolve_spec(g, spec, backend="single", cache=cache, device="cpu")
    assert len(cache) == 2
    n = len(sweep_candidates(int(g.m)))
    assert _count("tune.trials", "sketch_propagate", "single") == trials0 + n  # one a candidate
    for key, entry in cache.records().items():
        family, backend, impl = key.split("|")[:3]
        assert (backend, impl) == ("single", "cpu")
        m = entry["measurement"]
        assert m["speedup"] >= 1.0 and len(m["candidates"]) == n
        assert m["candidates"][0]["config"] == default_config(family).to_dict()
        assert m["tuned_us"] == min(c["us"] for c in m["candidates"])
    winner = cache.lookup(cache_key("sketch_propagate", backend="single", impl="cpu",
                                    model=spec.model, num_edges=int(g.m)))
    assert (out.item_edges, out.item_warps) == (winner.item_edges, winner.item_warps)
    assert Path(path).exists()
    again = TuningCache(path)
    assert resolve_spec(g, spec, backend="single", cache=again, device="cpu") == out
    assert len(again) == 2


def test_measure_the_ring_families_on_the_cpu():
    _, g = _graphs(scale=7)
    spec = RunSpec(num_registers=64, seed=1, backend="serial", mu_v=2, mu_s=2,
                   partition="degree", tuning="auto")
    cache = TuningCache(None)
    out = resolve_spec(g, spec, backend="serial", cache=cache, device="cpu")
    assert sorted(k.split("|")[0] for k in cache.records()) == ["bucket_propagate",
                                                                 "fused_sweep"]
    rec = cache.record(cache_key("fused_sweep", backend="serial", impl="cpu",
                                 model="wc", num_edges=int(g.m)))["measurement"]
    assert rec["candidates"][0]["label"] == "loop"
    assert all(c["label"].startswith("fused.lf") for c in rec["candidates"][1:])
    assert out.tuning == "auto" and out.mu_v == 2


def test_sweep_probe_outputs_do_not_depend_on_the_geometry():
    _, g = _graphs(scale=7)
    spec = RunSpec(num_registers=64, seed=2)
    for family in ("sketch_propagate", "cascade_step"):
        op = sweep_operands(g, spec, family, device="cpu")
        want = sweep_call(op, family, KernelConfig())()
        for c in sweep_candidates(op.edges.num_edges)[1:]:
            assert torch.equal(sweep_call(op, family, c)(), want)


# ------------------------------------------ byte-equal across the modes ----

def test_tuning_modes_byte_equal_on_the_single_backend(isolated_cache):
    rg, g = _graphs(scale=7)
    want = r_run(rg, 4, RSpec(num_registers=64, seed=3, backend="single")).result
    base = RunSpec(num_registers=64, seed=3, backend="single")
    off = InfluenceSession(g, base, device="cpu")
    res_off = off.find_seeds(4)
    m_off = off.build_sketch_matrix()[0]
    np.testing.assert_array_equal(res_off.seeds, want.seeds)
    key = cache_key("cascade_step", backend="single", impl="cpu", model="wc",
                    num_edges=int(g.m))
    cache = default_cache()
    cache.put(key, KernelConfig(item_edges=3))            # a hit for one family
    cache.put(key.replace("cascade_step", "sketch_propagate"),
              KernelConfig(item_edges=1, item_warps=8))
    cache.save()
    reset_default_cache()
    for mode in ("cached", "auto", "cached"):
        sess = InfluenceSession(g, base.with_(tuning=mode), device="cpu")
        res = sess.find_seeds(4)
        assert (sess.last_report.spec.item_edges, sess.last_report.spec.item_warps,
                sess.last_report.spec.cascade_item_edges) == (1, 8, 3)
        np.testing.assert_array_equal(res.seeds, res_off.seeds)
        np.testing.assert_array_equal(res.scores, res_off.scores)
        assert res.propagate_iters == res_off.propagate_iters
        assert res.stats["cascade_sweeps"] == res_off.stats["cascade_sweeps"]
        assert torch.equal(sess.build_sketch_matrix()[0], m_off)
    np.testing.assert_array_equal(m_off.numpy(), np.asarray(
        __import__("repro.core.difuser", fromlist=["x"]).build_sketch_matrix(
            rg, RSpec(num_registers=64, seed=3).difuser_config())[0]))


def test_tuning_modes_byte_equal_on_the_serial_backend(isolated_cache):
    rg, g = _graphs(scale=7)
    kw = dict(num_registers=64, seed=3, backend="serial", mu_v=2, mu_s=2)
    want = r_run(rg, 4, RSpec(**kw)).result
    base = RunSpec(**kw)
    res_off = run(g, 4, base, device="cpu").result
    np.testing.assert_array_equal(res_off.seeds, want.seeds)
    m_off = InfluenceSession(g, base, device="cpu").build_sketch_matrix()[0]
    cache = default_cache()
    key = cache_key("bucket_propagate", backend="serial", impl="cpu", model="wc",
                    num_edges=int(g.m))
    cache.put(key, KernelConfig(local_sweeps=1))
    cache.put(key.replace("bucket_propagate", "fused_sweep"),
              KernelConfig(fuse_sweeps=True))
    cache.save()
    reset_default_cache()
    cached = run(g, 4, base.with_(tuning="cached"), device="cpu")
    assert (cached.spec.local_sweeps, cached.spec.fuse_sweeps) == (1, True)
    np.testing.assert_array_equal(cached.result.seeds, res_off.seeds)
    np.testing.assert_array_equal(cached.result.scores, res_off.scores)
    assert cached.result.stats["cascade_sweeps"] == res_off.stats["cascade_sweeps"]
    sess = InfluenceSession(g, base.with_(tuning="cached"), device="cpu")
    assert torch.equal(sess.build_sketch_matrix()[0], m_off)
    cache_path = Path(isolated_cache)
    cache_path.unlink()
    reset_default_cache()
    auto = run(g, 4, base.with_(tuning="auto"), device="cpu")
    np.testing.assert_array_equal(auto.result.seeds, res_off.seeds)
    assert cache_path.exists() and len(TuningCache(str(cache_path))) == 2


def test_backend_hooks_run_at_the_tuned_geometry(isolated_cache, monkeypatch):
    """The single backend's fixpoint and cascade hooks lower their edges at
    the tuned spec's geometry; their matrices equal the untuned ones."""
    from repro_torch.core import difuser as T_difuser
    from repro_torch.runtime import get_backend

    _, g = _graphs(scale=7)
    spec = RunSpec(num_registers=64, seed=3)
    g2, x = T_difuser.normalize_inputs(g, spec.difuser_config())
    m0 = T_difuser._init_registers(g2.n_pad, g2.n, 64, "cpu")
    m0 = ops.sketch_fill(m0, seed=3)[:, :64].contiguous()
    single = get_backend("single")
    want_fix = single.fixpoint(m0, g2, spec, x, device="cpu")
    want_casc = single.cascade(want_fix[0], 5, g2, spec, x, device="cpu")
    cache = default_cache()
    key = cache_key("sketch_propagate", backend="single", impl="cpu", model="wc",
                    num_edges=int(g2.m))
    cache.put(key, KernelConfig(item_edges=2, item_warps=2))
    cache.put(key.replace("sketch_propagate", "cascade_step"), KernelConfig(item_edges=5))
    seen = []
    real = T_difuser.edge_operands

    def spy(*a, **kw):
        seen.append((kw["propagate"], kw["cascade"]))
        return real(*a, **kw)

    monkeypatch.setattr(T_difuser, "edge_operands", spy)
    tuned = spec.with_(tuning="cached")
    got_fix = single.fixpoint(m0, g2, tuned, x, device="cpu")
    got_casc = single.cascade(got_fix[0], 5, g2, tuned, x, device="cpu")
    assert seen == [(ItemGeometry(2, 2), ItemGeometry(5, 2))] * 2
    assert torch.equal(got_fix[0], want_fix[0]) and got_fix[1] == want_fix[1]
    assert torch.equal(got_casc[0], want_casc[0]) and got_casc[1] == want_casc[1]


def test_apply_tuning_off_never_imports_the_tuner():
    code = ("import sys\n"
            "from repro_torch.graphs import rmat_graph\n"
            "from repro_torch.runtime import RunSpec, run\n"
            "run(rmat_graph(5, edge_factor=4, seed=1), 2, RunSpec(num_registers=16),"
            " device='cpu')\n"
            "print('repro_torch.tune' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         check=True, timeout=300).stdout
    assert out.strip() == "False"


# ----------------------------------------------- the work-item geometry ----

def _rows(seed=5, n_rows=300):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 6, n_rows)
    deg[[3, 7, 11]] = (1500, 257, 64)                       # rows the cuts split
    deg[rng.random(n_rows) < 0.3] = 0                       # empty rows
    key = np.repeat(np.arange(n_rows), deg).astype(np.int32)
    nbr = rng.integers(0, n_rows, key.shape[0]).astype(np.int32)
    u = rng.integers(0, 1 << 31, (3, key.shape[0])).astype(np.int32)
    return group_rows(torch.from_numpy(key), torch.from_numpy(nbr), *map(torch.from_numpy, u),
                      n_rows), deg


@pytest.mark.parametrize("item_warps", [2, 4, 8])
@pytest.mark.parametrize("item_edges", [1, 3, 64, 256, 1024])
def test_work_list_geometry_invariants(item_edges, item_warps):
    rows, deg = _rows()
    w = work_list(rows.rowptr, item_edges, item_warps)
    assert (w.item_edges, w.item_warps) == (item_edges, item_warps)
    assert with_work(rows, item_edges, item_warps).work.item_edges == item_edges
    rowptr, ptr = rows.rowptr.numpy(), w.item_ptr.numpy()
    item_row, slot = w.item_row.numpy(), w.item_slot.numpy()
    size = np.diff(ptr)
    # every edge once and in order; no item longer than its size
    assert ptr[0] == 0 and ptr[-1] == deg.sum() and (size >= 0).all()
    assert size.max() <= item_edges
    assert (np.diff(item_row) >= 0).all()
    assert (rowptr[item_row] <= ptr[:-1]).all() and (ptr[1:] <= rowptr[item_row + 1]).all()
    pieces = np.bincount(item_row, minlength=deg.shape[0])
    np.testing.assert_array_equal(pieces, np.maximum(1, -(-deg // item_edges)))
    # split rows own consecutive partial slots, in order
    split = np.flatnonzero(deg > item_edges)
    np.testing.assert_array_equal(w.split_row.numpy(), split)
    assert (slot[np.isin(item_row, split, invert=True)] == -1).all()
    sp = w.split_ptr.numpy()
    assert w.num_partials == sp[-1] == (slot >= 0).sum()
    for k, r in enumerate(split):
        np.testing.assert_array_equal(slot[item_row == r], np.arange(sp[k], sp[k + 1]))


def test_work_list_defaults_and_refusals():
    rows, _ = _rows()
    w = work_list(rows.rowptr)
    assert (w.item_edges, w.item_warps) == (CHUNK, ITEM_WARPS)
    for bad in ((0, 4), (64, 0), (-1, 4)):
        with pytest.raises(ValueError):
            work_list(rows.rowptr, *bad)


def test_edge_operands_take_a_geometry_for_each_order():
    rng = np.random.default_rng(3)
    src, dst = (rng.integers(0, 50, 400).astype(np.int32) for _ in range(2))
    u = [rng.integers(0, 1 << 32, 400, dtype=np.uint64).astype(np.uint32) for _ in range(3)]
    e = EdgeOperands.from_numpy(src, dst, *u, 50, "cpu", propagate=ItemGeometry(3, 8),
                                cascade=ItemGeometry(7, 2))
    assert (e.by_src.work.item_edges, e.by_src.work.item_warps) == (3, 8)
    assert (e.by_dst.work.item_edges, e.by_dst.work.item_warps) == (7, 2)
    d = EdgeOperands.from_numpy(src, dst, *u, 50, "cpu")
    assert (d.by_src.work.item_edges, d.by_dst.work.item_warps) == (CHUNK, ITEM_WARPS)
    x = torch.from_numpy(u[0][:16].view(np.int32))
    m = torch.from_numpy(rng.integers(-1, 20, (50, 16)).astype(np.int8))
    for fn in (ops.propagate_sweep, ops.cascade_sweep):
        a, fa = fn(m, e, x, variant=0)
        b, fb = fn(m, d, x, variant=0)
        assert torch.equal(a, b) and torch.equal(fa, fb)


# ------------------------------------------------ block-shape libraries ----

def test_build_compiles_each_block_shape_into_a_library_of_its_own(monkeypatch, tmp_path):
    commands = []

    class FakeProcess:
        returncode = 0

        def __init__(self, cmd, **kw):
            commands.append(cmd)
            open(cmd[cmd.index("-o") + 1], "wb").close()

        def communicate(self):
            return "ptxas info", None

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeProcess)
    reports = build.build()
    others = [w for w in build.ITEM_WARPS if w != ITEM_WARPS]
    assert set(reports) == set(build.SOURCES) | {
        f"{s}-w{w}" for s in ("sketch_propagate", "cascade_step") for w in others}
    flags = {Path(c[-1]).stem + "".join(f for f in c if f.startswith("-DREPRO_ITEM_WARPS"))
             for c in commands}
    assert "sketch_propagate-DREPRO_ITEM_WARPS=8" in flags and "sketch_fill" in flags
    assert not any(f.startswith("fused_sweep-D") for f in flags)
    paths = {build.library_path("sketch_propagate", w) for w in build.ITEM_WARPS}
    assert len(paths) == len(build.ITEM_WARPS) and all(p.exists() for p in paths)
    assert build.library_path("sketch_propagate") == build.library_path("sketch_propagate",
                                                                        ITEM_WARPS)
    assert build.build() == {}                               # all there: nothing runs
    with pytest.raises(ValueError, match="warps a block only"):
        build.load("fused_sweep", 8)
    with pytest.raises(ValueError, match="not 3"):
        build.load("sketch_propagate", 3)


def test_load_keys_libraries_by_name_and_shape(monkeypatch, tmp_path):
    opened = []

    class FakeLibrary:
        def __init__(self, path):
            opened.append(Path(path).name)

        def __getattr__(self, symbol):
            return type("Fn", (), {})()

    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLibrary)
    for w in build.ITEM_WARPS:
        build.library_path("cascade_step", w).write_bytes(b"")
    fns = {w: build.load("cascade_step", w) for w in build.ITEM_WARPS}
    assert len({id(f) for f in fns.values()}) == len(build.ITEM_WARPS)
    assert build.load("cascade_step", 8) is fns[8]
    assert sorted(build._LOADED) == sorted(("cascade_step", w) for w in build.ITEM_WARPS)
    assert len(opened) == len(build.ITEM_WARPS)


# ------------------------------------------------------------ launchers ----

def test_im_tuning_cached_gives_the_seeds_of_off(isolated_cache, capsys):
    from repro_torch.launch import im

    argv = ["--graph", "rmat:8", "--k", "4", "--registers", "64", "--device", "cpu"]
    off = im.run(argv)
    auto = im.run(argv + ["--tuning", "auto"])
    cached = im.run(argv + ["--tuning", "cached"])
    assert off["seeds"] == auto["seeds"] == cached["seeds"]
    assert off["propagate_iters"] == cached["propagate_iters"]
    assert "tuning=cached: item_edges=" in capsys.readouterr().out
    assert len(TuningCache(str(isolated_cache))) == 2


def test_serve_tuning_auto_gives_the_answers_of_off(isolated_cache):
    from repro_torch.launch import serve_im

    def answers(results):
        out = []
        for r in results:
            v = r.value
            if isinstance(v, dict):
                out.append({k: np.asarray(x).tolist() for k, x in v.items()})
            else:
                out.append(np.asarray(getattr(v, "seeds", v)).tolist())
        return out

    argv = ["--graph", "rmat:8", "--registers", "64", "--queries", "32", "--topk", "4",
            "--device", "cpu"]
    _, off, off_results = serve_im.run(argv, return_session=True)
    _, auto, auto_results = serve_im.run(argv + ["--tuning", "auto"], return_session=True)
    assert auto.last_report.spec.tuning == "auto"
    np.testing.assert_array_equal(auto.last_report.result.seeds, off.last_report.result.seeds)
    assert answers(auto_results) == answers(off_results)
    assert torch.equal(auto.entry().matrix, off.entry().matrix)
    assert len(TuningCache(str(isolated_cache))) == 2


# ------------------------------------------------ on a CUDA device only ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    try:
        build.nvcc()
    except RuntimeError:
        pytest.skip(f"needs nvcc to build the kernels: none under $CUDA_HOME or on "
                    f"PATH ({shutil.which('nvcc')})")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["sketch_propagate", "cascade_step"])
def test_sweep_kernels_match_plain_at_every_geometry_on_cuda(cuda_device, family):
    from repro_torch.kernels import cascade_step, sketch_propagate

    _, g = _graphs(scale=10)
    spec = RunSpec(num_registers=256, seed=4)
    op = sweep_operands(g, spec, family, device=cuda_device)
    plain = (sketch_propagate.propagate_sweep_plain if family == "sketch_propagate"
             else cascade_step.cascade_sweep_plain)
    want = plain(op.m, op.edges, op.x, variant=op.variant)[0]
    for c in sweep_candidates(op.edges.num_edges):
        assert torch.equal(sweep_call(op, family, c)(), want), c
