"""The port's ``mesh`` backend (``runtime/mesh.py``, ``core/distributed.py``,
``launch/mesh.py``) against the reference's mesh, on the CPU.

The reference's mesh runs in one subprocess on 4 fake XLA devices; the
port's in one gloo world of 4 spawned ranks (``launch.mesh.spawn_world``,
a ``file://`` store under ``tmp_path``, a finite timeout). For each case:
seeds, rebuilds, sweep counts and x equal, gains and scores to rtol 1e-6,
the partition's measured stats equal; the hll cases with FASST also equal
the port's ``serial`` and ``single`` seeds; the ranks call only the plain
versions of the six kernels the path runs and launch nothing. The build is
byte-equal to the reference's mesh build and to the port's serial build.
``fm_mean`` and ``--no-fasst`` follow the reference's mesh, not its serial
ring. In the ranks' processes the whole partition's build and its
graph-wide sample sets raise, so no rank builds more than its own shard.
Also: ``supports`` and ``auto`` without a group and with one too small,
the front door under ``torch.distributed.run``, and ``im --no-fasst`` on
``single`` and ``serial`` against the reference launcher.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
GRAPH = "rmat:8"
K = 4
#: name -> RunSpec fields (mu_v x mu_s grid); J = 64 unless given
CASES = {
    "ring_2x2_wc": dict(mu_v=2, mu_s=2),
    "allgather_2x2_lt": dict(mu_v=2, mu_s=2, schedule="allgather", model="lt"),
    "ring_4x1_ic_fm_mean": dict(mu_v=4, mu_s=1, model="ic:0.1", estimator="fm_mean"),
    "ring_1x4_wc": dict(mu_v=1, mu_s=4),
    "ring_2x2_degree_fused": dict(mu_v=2, mu_s=2, partition="degree", local_sweeps=2,
                                  fuse_sweeps=True),
    "ring_2x2_j100": dict(mu_v=2, mu_s=2, num_registers=100),
    "ring_2x2_naive": dict(mu_v=2, mu_s=2, fasst=False, sort_x=False),
}
#: name -> (mu_v, mu_s, reg_offset) of the build-only path at J = 64
BUILDS = {"build_2x2_off0": (2, 2, 0), "build_2x2_off192": (2, 2, 192),
          "build_4x1_off0": (4, 1, 0)}
PATH_KERNELS = {"fused_sample", "sketch_fill", "sketch_cardinality", "fused_sweep",
                "bucket_propagate", "bucket_cascade"}
LAUNCH_ARGS = ["--graph", GRAPH, "--k", str(K), "--registers", "64"]

REF_SCRIPT = r"""
import contextlib, io, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
from repro.core.distributed import build_matrix_distributed
from repro.launch import im as R_im
from repro.launch.common import make_graph
from repro.launch.mesh import make_mesh
from repro.runtime import RunSpec, run

cases, builds, graph, k, launch_args, out = json.loads(sys.argv[1])
g = make_graph(graph, "0.1", 0)
arrays, info = {}, {}
for name, kw in cases.items():
    kw = dict(kw)
    rep = run(g, k, RunSpec(backend="mesh", num_registers=kw.pop("num_registers", 64), **kw))
    r = rep.result
    for f in ("seeds", "est_gains", "scores", "rebuilds", "x"):
        arrays[f"{name}.{f}"] = np.asarray(getattr(r, f))
    info[name] = dict(iters=int(r.propagate_iters), describe=rep.partition.stats().describe())
gs = g.sorted_by_dst()
x = np.sort(np.asarray(run(g, 1, RunSpec(num_registers=64)).result.x))
for name, (mu_v, mu_s, off) in builds.items():
    cfg = RunSpec(num_registers=64, mu_v=mu_v, mu_s=mu_s).distributed_config()
    m, iters, _ = build_matrix_distributed(gs, make_mesh((mu_v, mu_s), ("data", "model")),
                                           cfg, x, reg_offset=off)
    arrays[f"{name}.m"] = np.asarray(m)
    info[name] = dict(iters=int(iters))
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    res = R_im.run(launch_args + ["--devices", "4"])
info["launcher"] = dict(lines=buf.getvalue().splitlines(), seeds=res["seeds"],
                        backend=res["backend"])
np.savez(out, **arrays)
print(json.dumps(info))
"""


def _whole_build(*args, **kwargs):
    raise AssertionError("a mesh rank built the whole partition")


def _refuse_whole_builds():
    """In this rank's process, every name through which code reaches the
    whole partition's build or its graph-wide sample sets raises: each mesh
    rank prepares only its own shard (``partition.shard``)."""
    from repro_torch.partition import builder, plan, serial

    for module, name in ((builder, "build_partition_2d"), (serial, "build_partition_2d"),
                         (serial, "_prepare"), (plan, "sample_edge_sets"),
                         (builder, "sample_edge_sets"), (serial, "sample_edge_sets")):
        assert hasattr(module, name), (module, name)
        setattr(module, name, _whole_build)


def _port_world(rank, cases, builds, graph, k):
    """Every case on one rank of the world, with the whole partition's build
    refused; returns this rank's results."""
    import warnings

    import torch.distributed as dist

    from repro_torch.core.distributed import DistributedConfig, find_seeds_distributed
    from repro_torch.kernels import counters
    from repro_torch.launch.common import make_graph
    from repro_torch.launch.mesh import make_im_mesh
    from repro_torch.obs import shardprof
    from repro_torch.runtime import RunSpec, get_backend, resolve_backend, run

    _refuse_whole_builds()
    g = make_graph(graph, "0.1", 0)
    out = {"world": dist.get_world_size()}
    mesh_b = get_backend("mesh")
    out["supports_2x2"] = mesh_b.supports(g, RunSpec(mu_v=2, mu_s=2))
    out["supports_4x2"] = mesh_b.supports(g, RunSpec(mu_v=4, mu_s=2))
    out["auto_2x2"] = resolve_backend(RunSpec(mu_v=2, mu_s=2), g).name
    out["auto_4x2"] = resolve_backend(RunSpec(mu_v=4, mu_s=2), g).name
    for name, kw in cases.items():
        kw = dict(kw)
        spec = RunSpec(backend="mesh", num_registers=kw.pop("num_registers", 64), **kw)
        counters.reset()
        rep = run(g, k, spec, device="cpu")
        r = rep.result
        prof = shardprof.last_profile()
        out[name] = dict(
            seeds=r.seeds, est_gains=r.est_gains, scores=r.scores, rebuilds=r.rebuilds,
            x=r.x, iters=r.propagate_iters, describe=rep.partition.stats().describe(),
            launches=dict(counters.LAUNCHES), plain=dict(counters.PLAIN_CALLS),
            exchange=r.stats["exchange"], backend=rep.backend, device=rep.device,
            sweeps=r.propagate_iters + r.stats["cascade_sweeps"] + r.stats["rebuild_sweeps"],
            profile=(prof.backend, prof.per_step_timed, int(prof.step_bytes.sum())))
    # the deprecated shim runs the backend on the given mesh
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res, _ = find_seeds_distributed(g, k, make_im_mesh(4, device="cpu"),
                                        DistributedConfig(num_registers=64))
    out["shim"] = dict(seeds=res.seeds, warned=any(
        issubclass(w.category, DeprecationWarning) for w in caught))
    gs = g.sorted_by_dst()
    x = np.sort(run(g, 1, RunSpec(num_registers=64), device="cpu").result.x)
    for name, (mu_v, mu_s, off) in builds.items():
        spec = RunSpec(num_registers=64, mu_v=mu_v, mu_s=mu_s, backend="mesh")
        m, iters = mesh_b.build_matrix(gs, spec, x, reg_offset=off, normalized=True,
                                       device="cpu")
        out[name] = dict(m=m.numpy(), iters=iters)
    return out


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The port's CPU runs in this process are tiny; with every core's
    thread each, beside the world's ranks and the other test workers, they
    spend their time in thread hand-offs. Two threads, restored after."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_mesh") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    arg = json.dumps([CASES, BUILDS, GRAPH, K, LAUNCH_ARGS, str(out)])
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, arg], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_proc):
    proc, path = ref_proc
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    info = json.loads(stdout.strip().splitlines()[-1])
    with np.load(path) as z:
        arrays = {key: z[key] for key in z.files}
    return info, arrays


@pytest.fixture(scope="module")
def port(ref_proc, tmp_path_factory):
    """The port's world (started after the reference's subprocess, so the
    two overlap); rank 0's results and every rank's."""
    from repro_torch.launch.mesh import spawn_world

    ranks = spawn_world(_port_world, 4, workdir=tmp_path_factory.mktemp("world"),
                        device="cpu", args=(CASES, BUILDS, GRAPH, K), timeout_s=60)
    return ranks


def _graph():
    from repro_torch.launch.common import make_graph

    return make_graph(GRAPH, "0.1", 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_equals_the_reference_mesh(name, ref, port):
    info, arrays = ref
    got = port[0][name]
    np.testing.assert_array_equal(got["seeds"], arrays[f"{name}.seeds"])
    np.testing.assert_array_equal(got["rebuilds"], arrays[f"{name}.rebuilds"])
    np.testing.assert_array_equal(got["x"], arrays[f"{name}.x"])
    assert got["iters"] == info[name]["iters"]
    np.testing.assert_allclose(got["est_gains"], arrays[f"{name}.est_gains"], rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(got["scores"], arrays[f"{name}.scores"], rtol=1e-6, atol=0)
    assert got["describe"] == info[name]["describe"]
    assert (got["backend"], got["device"]) == ("mesh", "cpu")
    for other in port[1:]:   # every rank returns the same result
        np.testing.assert_array_equal(other[name]["seeds"], got["seeds"])
        assert other[name]["iters"] == got["iters"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_runs_only_the_paths_plain_kernels(name, port):
    for rank in port:
        got = rank[name]
        assert got["launches"] == {}, got["launches"]
        assert set(got["plain"]) <= PATH_KERNELS, got["plain"]
        need = {"fused_sample", "sketch_fill", "sketch_cardinality", "bucket_cascade"}
        if CASES[name].get("fuse_sweeps"):
            need.add("fused_sweep")
        assert need <= set(got["plain"]), got["plain"]
        # the ring moves blocks only where the grid has more than one vertex shard
        shifted = rank[name]["exchange"].get("ring_shift", {}).get("calls", 0)
        ring = CASES[name].get("schedule", "ring") == "ring" and CASES[name]["mu_v"] > 1
        assert (shifted > 0) == ring
        assert got["profile"][:2] == ("mesh", False) and got["profile"][2] > 0
        # the selection sums over the sim shards by one ordered sum a round
        # (all_to_all and all_gather of 1/mu_s chunks); the all_gathers carry
        # only the argmax's (best, seed) pairs, and the allgather schedule's
        # blocks, one a sweep: no rank gathers every shard's (2, n_loc) sums
        ex, mu_v = got["exchange"], CASES[name]["mu_v"]
        assert ex["ordered_sum"]["calls"] == K, ex
        assert (ex["ordered_sum"]["bytes_sent"] > 0) == (CASES[name]["mu_s"] > 1), ex
        if ring:
            assert ex["all_gather"]["calls"] == K, ex
            assert ex["all_gather"]["bytes_sent"] == (16 * K if mu_v > 1 else 0), ex
        elif CASES[name].get("schedule") == "allgather":
            assert ex["all_gather"]["calls"] == K + got["sweeps"], ex


@pytest.mark.parametrize("name", sorted(n for n, kw in CASES.items()
                                        if kw.get("estimator", "hll") == "hll"
                                        and kw.get("fasst", True)))
def test_mesh_equals_the_ports_serial_and_single(name, port):
    from repro_torch.runtime import RunSpec, run

    kw = dict(CASES[name])
    kw.pop("schedule", None)
    j = kw.pop("num_registers", 64)
    g = _graph()
    serial = run(g, K, RunSpec(backend="serial", num_registers=j, **kw), device="cpu").result
    single = run(g, K, RunSpec(num_registers=j, model=kw.get("model", "wc")),
                 device="cpu").result
    np.testing.assert_array_equal(port[0][name]["seeds"], serial.seeds)
    np.testing.assert_array_equal(port[0][name]["seeds"], single.seeds)
    assert port[0][name]["iters"] == serial.propagate_iters


def test_fm_mean_and_no_fasst_follow_the_reference_mesh(ref, port):
    """The mesh sums 2^-M for fm_mean (as the single path does) and keeps x
    unsorted without FASST; the serial ring sums M and sorts x."""
    from repro_torch.runtime import RunSpec, run

    g = _graph()
    fm = dict(CASES["ring_4x1_ic_fm_mean"])
    serial = run(g, K, RunSpec(backend="serial", num_registers=64, **fm), device="cpu").result
    single = run(g, K, RunSpec(num_registers=64, model=fm["model"], estimator="fm_mean"),
                 device="cpu").result
    got = port[0]["ring_4x1_ic_fm_mean"]
    np.testing.assert_array_equal(got["seeds"], single.seeds)
    assert got["seeds"].tolist() != serial.seeds.tolist()
    naive = port[0]["ring_2x2_naive"]["x"]
    assert (np.diff(naive.astype(np.int64)) < 0).any(), "x came back sorted"
    np.testing.assert_array_equal(np.sort(naive), port[0]["ring_2x2_wc"]["x"])


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_mesh_build_matrix_is_byte_equal(name, ref, port):
    from repro_torch.runtime import RunSpec, get_backend

    info, arrays = ref
    mu_v, mu_s, off = BUILDS[name]
    got = port[0][name]
    np.testing.assert_array_equal(got["m"], arrays[f"{name}.m"])
    assert got["iters"] == info[name]["iters"]
    g = _graph().sorted_by_dst()
    from repro_torch.runtime import run

    x = np.sort(run(_graph(), 1, RunSpec(num_registers=64), device="cpu").result.x)
    serial, _ = get_backend("serial").build_matrix(
        g, RunSpec(num_registers=64, mu_v=mu_v, mu_s=mu_s), x, reg_offset=off,
        normalized=True, device="cpu")
    np.testing.assert_array_equal(got["m"], serial.numpy())
    for other in port[1:]:
        np.testing.assert_array_equal(other[name]["m"], got["m"])


def test_deprecated_shim_equals_the_backend(port):
    got = port[0]["shim"]
    assert got["warned"]
    np.testing.assert_array_equal(got["seeds"], port[0]["ring_2x2_wc"]["seeds"])


def test_supports_and_auto_inside_a_world(port):
    got = port[0]
    assert got["world"] == 4
    assert got["supports_2x2"] == (True, "")
    ok, why = got["supports_4x2"]
    assert not ok and "8 shards" in why and "4 rank" in why
    assert (got["auto_2x2"], got["auto_4x2"]) == ("mesh", "serial")


def test_supports_and_auto_without_a_group():
    import types

    import torch
    import torch.distributed as dist

    from repro_torch.runtime import BackendUnavailable, RunSpec, get_backend, resolve_backend

    assert not dist.is_initialized()
    ok, why = get_backend("mesh").supports(None, RunSpec(mu_v=2, mu_s=2))
    assert not ok and "no process group" in why
    assert resolve_backend(RunSpec(mu_v=2, mu_s=2)).name == "serial"
    assert resolve_backend(RunSpec()).name == "single"
    with pytest.raises(BackendUnavailable, match="no process group"):
        resolve_backend(RunSpec(backend="mesh", mu_v=2, mu_s=2))
    caps = get_backend("mesh").capabilities()
    assert caps.shard_repair and caps.needs_mesh
    # the repair makes its serving mesh over the process group, which is missing
    plan = types.SimpleNamespace(mu_v=2, n_loc=4)
    with pytest.raises(RuntimeError, match="no process group"):
        get_backend("mesh").repair_plan_shards(None, RunSpec(), None, torch.zeros((8, 4)),
                                               plan, (0,))


def test_make_mesh_refuses_a_grid_larger_than_the_world(tmp_path):
    from repro_torch.launch.mesh import spawn_world

    with pytest.raises(Exception):   # the rank's ValueError fails the spawn
        spawn_world(_grid_too_large, 1, workdir=tmp_path, device="cpu", timeout_s=30)


def _grid_too_large(rank):
    from repro_torch.launch.mesh import make_mesh

    make_mesh((2, 2), ("data", "model"), device="cpu")


def test_front_door_under_torchrun(ref, tmp_path):
    """``torch.distributed.run`` with 4 ranks prints the reference launcher's
    lines and its seeds under ``--devices 4`` on 4 devices."""
    info, _ = ref
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch", "im", *LAUNCH_ARGS,
           "--devices", "4", "--backend", "mesh", "--device", "cpu"]
    proc = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    want = info["launcher"]
    assert want["backend"] == "mesh"
    for line in want["lines"]:
        if line.startswith("difuser:"):   # the wall time differs
            tail = line.split("s ", 1)[1]
            assert any(ln.startswith("difuser:") and ln.endswith(tail) for ln in lines), tail
        else:
            assert line in lines, line
    assert lines.count(f"seeds: {want['seeds']}") == 1, proc.stdout   # rank 0 alone
    mesh = [ln for ln in lines if ln.startswith("mesh: ")]
    assert mesh == ["mesh: world=4 grid=2x2 (data, model) transport=gloo "
                    "devices=cpu,cpu,cpu,cpu"]


@pytest.mark.parametrize("backend", ["single", "serial"])
def test_im_no_fasst_prints_the_reference_launchers_seeds(backend, capsys):
    from repro.launch import im as R_im
    from repro_torch.launch import im as T_im

    extra = ["--backend", backend, "--no-fasst"]
    want = R_im.run(LAUNCH_ARGS + extra)
    got = T_im.run(LAUNCH_ARGS + extra + ["--device", "cpu"])
    assert got["seeds"] == want["seeds"]
    printed = capsys.readouterr().out
    assert re.search(rf"^seeds: {re.escape(str(want['seeds']))}$", printed, re.M)
    fasst = T_im.run(LAUNCH_ARGS + ["--backend", backend, "--device", "cpu"])
    if backend == "serial":   # the ring sorts whatever x it is given
        assert fasst["seeds"] == got["seeds"]


def test_add_partition_bytes_matches_the_reference():
    from repro.obs import shardprof as R_sp
    from repro_torch.obs import shardprof as T_sp

    counts = np.random.default_rng(5).integers(0, 1000, size=(3, 2, 3)).astype(np.int64)
    want = R_sp.ShardProfiler(3, 2, backend="mesh", phase="build")
    got = T_sp.ShardProfiler(3, 2, backend="mesh", phase="build")
    for prof in (want, got):
        prof.add_partition_bytes(counts, 48, 7)
    np.testing.assert_array_equal(got.step_bytes, want.step_bytes)
    assert got.sweeps == want.sweeps and not got.per_step_timed
