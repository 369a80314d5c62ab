"""Device-resident serving and shard repair on the port's process mesh
(``launch.mesh.serve_world``, ``StoreEntry.place_on_mesh``, the shard-local
queries, the mesh's warm rounds and ``repair_plan_shards``) against the
port's host-resident paths and the reference's device-resident ones, on
the CPU.

The reference runs once, in one subprocess on 4 fake XLA devices; the port
in one gloo world of 4 spawned ranks, rank 0 the controller and the others
following it. Both take rmat:8 at J = 64 and the same query sets and
deltas. Device answers are byte-equal to the port's host answers and within
``tests/test_torch_service.py``'s tolerances of the reference's; warm top-k
seeds equal cold ones; mesh repairs are byte-equal to the serial repair, to
a full rebuild and to the reference's mesh repair, with its sweeps and
shards swept. Also: routing, residency resolution, capabilities, the
session's own placement, preconditions and lifecycle, snapshots in both
directions, the async engine with a delta in flight, the front door under
``torch.distributed.run``, and that the ranks run only plain versions.
"""
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
GRAPH = "rmat:8"
J = 64
SEED = 3
K = 4
MU_V = 4
#: name -> (strategy, estimator, model)
CASES = {"degree_hll_wc": ("degree", "hll", "wc"),
         "block_fm_mean_lt": ("block", "fm_mean", "lt")}
MAIN = "degree_hll_wc"
PATH_KERNELS = {"fused_sample", "sketch_fill", "sketch_cardinality", "bucket_propagate",
                "bucket_cascade"}

REF_SCRIPT = r"""
import json, os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
from repro.core.difuser import DiFuserConfig
from repro.graphs.structs import GraphDelta
from repro.launch.common import make_graph
from repro.launch.mesh import make_serving_mesh
from repro.partition import plan_partition
from repro.service import SketchStore, apply_delta
from repro.service import queries as Q

inp, out, ref_snap, port_snap = json.loads(sys.argv[1])
g = make_graph(inp["graph"], "0.1", 0)
mesh = make_serving_mesh(inp["mu_v"])
arrays, info = {}, {}


def answers(e, tag):
    arrays[tag + ".spread"] = np.asarray(Q.spread_estimates(e, [tuple(s) for s in inp["sets"]]))
    arrays[tag + ".marginal"] = np.asarray(Q.marginal_gains(
        e, inp["cands"], [tuple(c) for c in inp["committed"]]))
    est, reg = Q.coverage_probes(e, inp["verts"])
    arrays[tag + ".probe"], arrays[tag + ".probe_reg"] = np.asarray(est), np.asarray(reg)


def top(store, e, tag):
    r = Q.top_k_seeds(store, e, inp["k"])
    for f in ("seeds", "est_gains", "scores", "rebuilds"):
        arrays[f"{tag}.{f}"] = np.asarray(getattr(r, f))


def delta(d):
    return GraphDelta.make(add=(d["add"][0], d["add"][1]) if d["add"] else None,
                           remove=(d["rem"][0], d["rem"][1]) if d["rem"] else None)


for name, (strategy, estimator, model) in inp["cases"].items():
    cfg = DiFuserConfig(num_registers=inp["j"], seed=inp["seed"], estimator=estimator,
                        model=model)
    store = SketchStore()
    e = store.get_or_build(g, cfg)
    store.attach_plan(e.key, plan_partition(e.graph, inp["mu_v"], mu_s=1, strategy=strategy,
                                            x=e.x, seed=inp["seed"], model=model))
    e.place_on_mesh(mesh)
    answers(e, name)
    top(store, e, name)
    if name == inp["main"]:
        store.save(ref_snap + ".tmp", e.key)
        os.replace(ref_snap + ".tmp.npz", ref_snap)
    for i, d in enumerate(inp["deltas"][name]):
        rep = apply_delta(store, e.key, delta(d), backend="auto")
        e = store.entry(e.key)
        info[f"{name}.delta{i}"] = dict(
            backend=rep.repair_backend, sweeps=rep.repair_sweeps,
            swept=list(rep.shards_swept), touched=list(rep.plan_shards_touched),
            banks=rep.banks_touched, rebuilt=rep.rebuilt, stale=rep.stale,
            residency=e.residency)
        arrays[f"{name}.delta{i}.m"] = np.asarray(e.matrix)
        if rep.stale:
            top(store, e, f"{name}.delta{i}")
            arrays[f"{name}.delta{i}.rebuilt_m"] = np.asarray(store.entry(e.key).matrix)
t_end = time.time() + 240
while not os.path.exists(port_snap):
    if time.time() > t_end:
        raise TimeoutError(port_snap)
    time.sleep(0.2)
answers(SketchStore().load(port_snap, mesh=mesh), "port_snap")
np.savez(out, **arrays)
print(json.dumps(info))
"""


@functools.lru_cache(maxsize=None)
def _inputs() -> dict:
    """The query sets and deltas both sides take (made with the port; the
    graphs and plans are the reference's byte for byte)."""
    from repro_torch.core.difuser import DiFuserConfig
    from repro_torch.launch.common import make_graph
    from repro_torch.partition import plan_partition
    from repro_torch.service import SketchStore

    g = make_graph(GRAPH, "0.1", 0)
    e = SketchStore(device="cpu").get_or_build(g, DiFuserConfig(num_registers=J, seed=SEED))
    plan = plan_partition(e.graph, MU_V, mu_s=1, strategy="degree", x=e.x, seed=SEED,
                          device="cpu")
    rng = np.random.default_rng(17)
    n = g.n

    def ints(size):
        return [int(v) for v in rng.integers(0, n, size)]

    in_0 = np.flatnonzero(plan.owner_of(np.arange(n)) == 0)
    local = [[int(v) for v in rng.choice(in_0, 12)] for _ in range(2)]
    gs = e.graph
    return dict(
        graph=GRAPH, j=J, seed=SEED, k=K, mu_v=MU_V, main=MAIN, cases=CASES,
        sets=[ints(int(rng.integers(1, 7))) for _ in range(12)],
        cands=ints(8), committed=[ints(int(rng.integers(0, 4))) for _ in range(8)],
        verts=ints(16),
        deltas={MAIN: [dict(add=[ints(24), ints(24)], rem=None),      # async, in flight
                       dict(add=local, rem=None),                     # inside shard 0
                       dict(add=None, rem=[[int(gs.src[0]), int(gs.src[1])],
                                           [int(gs.dst[0]), int(gs.dst[1])]])],
                "block_fm_mean_lt": [dict(add=[ints(8), ints(8)], rem=None)]})


def _delta(d):
    from repro_torch.graphs import GraphDelta

    return GraphDelta.make(add=(d["add"][0], d["add"][1]) if d["add"] else None,
                           remove=(d["rem"][0], d["rem"][1]) if d["rem"] else None)


def _exact(value) -> bytes:
    """A query answer as bytes: equal bytes, byte-equal answers."""
    if isinstance(value, dict):
        return value["est"].tobytes() + value["max_register"].tobytes()
    if hasattr(value, "seeds"):
        return b"".join(np.asarray(a).tobytes()
                        for a in (value.seeds, value.est_gains, value.scores, value.rebuilds))
    return np.float64(value).tobytes()


def _answers(Q, e, inp) -> dict:
    est, reg = Q.coverage_probes(e, inp["verts"])
    return dict(spread=Q.spread_estimates(e, [tuple(s) for s in inp["sets"]]),
                marginal=Q.marginal_gains(e, inp["cands"], [tuple(c) for c in inp["committed"]]),
                probe=est, probe_reg=reg)


def _top(r) -> dict:
    return {f: np.asarray(getattr(r, f)) for f in ("seeds", "est_gains", "scores", "rebuilds")}


def _port_world(rank, inp, ref_snap, port_snap):
    """Rank 0 controls a serving world and runs every port-side case; the
    other ranks follow. Returns rank 0's results, and each rank's launch
    counters."""
    import torch.distributed as dist

    from repro_torch.core.difuser import DiFuserConfig
    from repro_torch.kernels import counters
    from repro_torch.launch import mesh as M
    from repro_torch.launch.common import make_graph
    from repro_torch.partition import plan_partition
    from repro_torch.runtime import RunSpec, get_backend
    from repro_torch.service import SketchStore

    g = make_graph(inp["graph"], "0.1", 0)
    # before the serving world: the mesh repair of a plain tensor, SPMD on every rank
    cfg = DiFuserConfig(num_registers=inp["j"], seed=inp["seed"])
    e = SketchStore(device="cpu").get_or_build(g, cfg)
    plan = plan_partition(e.graph, inp["mu_v"], mu_s=1, strategy="degree", x=e.x,
                          seed=inp["seed"], device="cpu")
    e.plan = plan
    d0 = _delta(inp["deltas"][inp["main"]][0])
    new_g = e.graph.apply_delta(d0).sorted_by_dst()
    touched = tuple(np.unique(plan.owner_of(np.concatenate([d0.add_src, d0.add_dst]))).tolist())
    spmd = get_backend("mesh").repair_plan_shards(new_g, RunSpec.from_config(cfg), e.x,
                                                  e.planned_matrix(), plan, touched)
    out = {"spmd": (spmd[0].numpy(), spmd[1], spmd[2])}
    kept = {}
    counters.reset()      # the serving world's launches alone
    res = M.serve_world(lambda: _controller(g, inp, ref_snap, port_snap, out, kept),
                        graphs=[g])
    if rank == 0:
        # the world has stopped: a device entry's mesh is gone
        from repro_torch.service import queries as Q

        try:
            Q.spread_estimates(kept["entry"], [(1, 2)])
            out["after_stop"] = "answered"
        except RuntimeError as err:
            out["after_stop"] = str(err)
        out.update(res)
    out["counters"] = (dict(counters.LAUNCHES), dict(counters.PLAIN_CALLS))
    out["world"] = dist.get_world_size()
    return out


def _controller(g, inp, ref_snap, port_snap, out, kept):
    import warnings

    from repro_torch.core.difuser import DiFuserConfig, find_seeds
    from repro_torch.launch import mesh as M
    from repro_torch.partition import plan_partition
    from repro_torch.runtime import InfluenceSession, RunSpec
    from repro_torch.service import SketchStore, apply_delta
    from repro_torch.service import queries as Q

    mesh = M.require_controller().serving_mesh(inp["mu_v"], device="cpu")
    res = {}
    for name, (strategy, estimator, model) in inp["cases"].items():
        cfg = DiFuserConfig(num_registers=inp["j"], seed=inp["seed"], estimator=estimator,
                            model=model)
        store, host = SketchStore(device="cpu"), SketchStore(device="cpu")
        e, he = store.get_or_build(g, cfg), host.get_or_build(g, cfg)
        plan = plan_partition(e.graph, inp["mu_v"], mu_s=1, strategy=strategy, x=e.x,
                              seed=inp["seed"], model=model, device="cpu")
        store.attach_plan(e.key, plan)
        host.attach_plan(he.key, plan)
        e.place_on_mesh(mesh)
        r = res[name] = dict(residency=e.residency, serving=e.serving_backend,
                             device_bytes=e.device_bytes(), rows=plan.n_pad,
                             device=_answers(Q, e, inp), host=_answers(Q, he, inp),
                             with_c=Q.spread_estimates(he, [tuple(c) + (v,) for c, v in
                                                            zip(inp["committed"],
                                                                inp["cands"])]))
        r["warm"] = _top(Q.top_k_seeds(store, e, inp["k"]))
        r["cold"] = _top(find_seeds(e.graph, inp["k"], cfg, x=e.x, device="cpu"))
        if name == inp["main"]:
            _main_case(store, e, host, he, cfg, inp, r, port_snap)
            r["to_host"] = _lifecycle(store, e, he, cfg, g, inp, mesh, r)
            kept["entry"] = e
        else:
            for i, d in enumerate(inp["deltas"][name]):
                rep = apply_delta(store, e.key, _delta(d))
                e = store.entry(e.key)
                fresh = SketchStore(device="cpu").get_or_build(e.graph, cfg, x=e.x)
                r[f"delta{i}"] = dict(rep=rep.__dict__, residency=e.residency,
                                      m=e.matrix.numpy(), rebuilt_m=fresh.matrix.numpy())

    # the session places its entry itself, and repairs on the mesh
    spec = RunSpec(num_registers=inp["j"], seed=inp["seed"], backend="mesh", mu_v=2, mu_s=2,
                   partition="degree")
    sess = InfluenceSession(g, spec, device="cpu")
    se = sess.entry()
    warm = sess.find_seeds_warm(inp["k"])
    cold = sess.find_seeds(inp["k"])
    rep = sess.apply_delta(_delta(inp["deltas"][inp["main"]][0]))
    pinned = InfluenceSession(g, spec.with_(mu_v=inp["mu_v"], mu_s=1), device="cpu",
                              mesh=mesh)
    res["session"] = dict(residency=se.residency, plan_mu_v=se.plan.mu_v,
                          mesh=se.mesh.shape, warm=warm.seeds, cold=cold.seeds,
                          cold_backend=sess.last_report.backend,
                          repair=rep.repair_backend,
                          pinned_mesh=pinned._serving_mesh(plan_partition(
                              se.graph, inp["mu_v"], mu_s=1, x=se.x, seed=inp["seed"],
                              device="cpu")) is mesh)

    # two banks: each a column slice of the placed blocks
    cfg = DiFuserConfig(num_registers=inp["j"], seed=inp["seed"])
    s2, h2 = SketchStore(num_banks=2, device="cpu"), SketchStore(num_banks=2, device="cpu")
    e2, he2 = s2.get_or_build(g, cfg), h2.get_or_build(g, cfg)
    plan2 = plan_partition(e2.graph, inp["mu_v"], mu_s=1, strategy="degree", x=e2.x,
                           seed=inp["seed"], device="cpu")
    s2.attach_plan(e2.key, plan2)
    h2.attach_plan(he2.key, plan2)
    e2.place_on_mesh(mesh)
    banked = dict(shapes=[tuple(b.shape) for b in e2.banks], rows=plan2.n_pad,
                  device=_answers(Q, e2, inp),
                  host=_answers(Q, he2, inp))
    d1 = _delta(inp["deltas"][inp["main"]][1])
    rep2, rep2_h = apply_delta(s2, e2.key, d1), apply_delta(h2, he2.key, d1, backend="serial")
    banked.update(rep=rep2.__dict__, serial=rep2_h.__dict__,
                  m=s2.entry(e2.key).matrix.numpy(), serial_m=h2.entry(he2.key).matrix.numpy())
    res["two_banks"] = banked

    # a graph no follower was started with: every rank gets it when it is placed
    from repro_torch.launch.common import make_graph

    g7 = make_graph("rmat:7", "0.1", 1)
    cfg7 = DiFuserConfig(num_registers=inp["j"], seed=inp["seed"])
    s7 = SketchStore(device="cpu")
    e7 = s7.get_or_build(g7, cfg7)
    s7.attach_plan(e7.key, plan_partition(e7.graph, inp["mu_v"], mu_s=1, x=e7.x,
                                          seed=inp["seed"], device="cpu"))
    e7.place_on_mesh(mesh)
    res["new_graph"] = dict(warm=Q.top_k_seeds(s7, e7, inp["k"]).seeds,
                            cold=find_seeds(e7.graph, inp["k"], cfg7, x=e7.x,
                                            device="cpu").seeds)

    # snapshots: the reference's device snapshot placed on this mesh; this
    # package's loaded without a mesh
    t_end = time.time() + 240
    while not os.path.exists(ref_snap):
        if time.time() > t_end:
            raise TimeoutError(ref_snap)
        time.sleep(0.2)
    placed = SketchStore(device="cpu").load(ref_snap, mesh=mesh)
    res["ref_snap"] = dict(residency=placed.residency, answers=_answers(Q, placed, inp))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        loose = SketchStore(device="cpu").load(port_snap)
    res["port_snap_meshless"] = dict(
        residency=loose.residency, answers=_answers(Q, loose, inp),
        warned=[str(w.message) for w in caught])
    res["exchange"] = mesh.exchange.summary()
    return res


def _main_case(store, e, host, he, cfg, inp, r, port_snap):
    """Engines, the async engine with a delta in flight, the mesh repairs
    against the serial one, and a removal then a top-k."""
    from repro_torch.core.difuser import find_seeds
    from repro_torch.core.distributed import _rank_partition
    from repro_torch.kernels import counters
    from repro_torch.launch.serve_im import make_workload
    from repro_torch.runtime import RunSpec
    from repro_torch.service import (AsyncInfluenceEngine, InfluenceEngine, Request,
                                     SketchStore, apply_delta)
    from repro_torch.service import queries as Q

    store.save(port_snap + ".tmp", e.key)
    os.replace(port_snap + ".tmp.npz", port_snap)
    stream = make_workload(e.graph.n, 64, k=inp["k"], seed=7)
    sync = [x.value for x in InfluenceEngine(store).run([Request(e.key, q) for q in stream])]
    r["engine_backends"] = sorted({x.backend for x in
                                   InfluenceEngine(store).run([Request(e.key, q)
                                                               for q in stream[:8]])})
    r["sync_equals_host"] = [_exact(a) for a in sync] == [
        _exact(x.value) for x in InfluenceEngine(host).run([Request(he.key, q)
                                                            for q in stream])]
    deltas = inp["deltas"][inp["main"]]
    version_n = e.matrix.numpy().copy()
    with AsyncInfluenceEngine(InfluenceEngine(store), deadline_ms=20) as aeng:
        first = [aeng.submit(e.key, q) for q in stream]
        pending = aeng.apply_delta_async(e.key, _delta(deltas[0]), backend="auto")
        during = []
        while not pending.done():
            during.append(aeng.submit(e.key, stream[len(during) % len(stream)]))
            time.sleep(0.002)
        after = [aeng.submit(e.key, q) for q in stream]
        aeng.drain()
        rep = pending.result()
    e._matrix_cache = None    # gather version N's blocks again: the repair wrote new ones
    r["version_n_kept"] = e.matrix.numpy().tobytes() == version_n.tobytes()
    post = [x.value for x in InfluenceEngine(store).run([Request(e.key, q) for q in stream])]
    pre_b, post_b = [_exact(a) for a in sync], [_exact(a) for a in post]
    r["async"] = dict(
        first=all(_exact(f.result().value) in (a, b)
                  for f, a, b in zip(first, pre_b, post_b)),
        during=all(_exact(f.result().value) in (pre_b[i % len(stream)], post_b[i % len(stream)])
                   for i, f in enumerate(during)),
        after=[_exact(f.result().value) for f in after] == post_b, n_during=len(during))
    e = store.entry(e.key)
    rep_s = apply_delta(host, he.key, _delta(deltas[0]), backend="serial")
    r["delta0"] = _repair_record(rep, rep_s, e, host.entry(he.key), cfg)
    merges = counters.PLAIN_CALLS.get("bucket_propagate", 0)
    rep = apply_delta(store, e.key, _delta(deltas[1]))
    merges = counters.PLAIN_CALLS.get("bucket_propagate", 0) - merges
    rep_s = apply_delta(host, he.key, _delta(deltas[1]), backend="serial")
    e = store.entry(e.key)
    r["delta1"] = _repair_record(rep, rep_s, e, host.entry(he.key), cfg)
    # rank 0's merges against a repair that merged every ring step of every sweep
    dcfg = RunSpec.from_config(cfg).distributed_config()
    part, _ = _rank_partition(e.graph, e.mesh, dcfg, e.x, e.plan)
    r["delta1"]["merges"] = (merges, rep.repair_sweeps
                             * sum(int(a.shape[-1]) > 0 for a in part.p_h))
    rep = apply_delta(store, e.key, _delta(deltas[2]))
    e = store.entry(e.key)
    stale_rec = dict(rep=rep.__dict__, stale=e.stale, residency=e.residency)
    warm = Q.top_k_seeds(store, e, inp["k"])
    e = store.entry(e.key)
    stale_rec.update(warm=_top(warm), after_stale=e.stale, after_residency=e.residency,
                     cold=_top(find_seeds(e.graph, inp["k"], cfg, x=e.x, device="cpu")),
                     rebuilt_m=e.matrix.numpy(),
                     fresh_m=SketchStore(device="cpu").get_or_build(e.graph, cfg,
                                                                    x=e.x).matrix.numpy())
    r["delta2"] = stale_rec


def _repair_record(rep, rep_s, e, he, cfg) -> dict:
    from repro_torch.service import SketchStore

    fresh = SketchStore(device="cpu").get_or_build(e.graph, cfg, x=e.x)
    return dict(rep=rep.__dict__, serial=rep_s.__dict__, residency=e.residency,
                m=e.matrix.numpy(), serial_m=he.matrix.numpy(), rebuilt_m=fresh.matrix.numpy())


def _lifecycle(store, e, he, cfg, g, inp, mesh, r) -> dict:
    """Preconditions of placement, refusals of a device entry, ``to_host``."""
    from repro_torch.launch import mesh as M
    from repro_torch.partition import plan_partition
    from repro_torch.service import CostAwareEvictor, SketchStore

    refused = {}
    bare = SketchStore(device="cpu").get_or_build(g, cfg)
    for what, call in (
            ("no_plan", lambda: bare.place_on_mesh(mesh)),
            ("mu_v", lambda: (setattr(bare, "plan", plan_partition(
                bare.graph, 2, mu_s=1, x=bare.x, seed=inp["seed"], device="cpu")),
                bare.place_on_mesh(mesh))),
            ("sim_axis", lambda: bare.place_on_mesh(M.require_controller().make_mesh(
                (2, 2), ("data", "model"), device="cpu"))),
            ("attach_plan", lambda: store.attach_plan(e.key, e.plan)),
            ("evict", lambda: store.evict(e.key))):
        try:
            call()
            refused[what] = None
        except ValueError as err:
            refused[what] = str(err)
    r["refused"] = refused
    try:       # SPMD only: the followers wait for records, not for new_group
        M.make_serving_mesh(2, device="cpu")
        r["spmd_mesh_on_controller"] = None
    except RuntimeError as err:
        r["spmd_mesh_on_controller"] = str(err)
    r["evictor_victims"] = CostAwareEvictor(0).enforce(store)
    r["evictor_evictable"] = CostAwareEvictor(0).evictable(e)
    clone = store.shadow(e.key).entry(e.key)
    matrix = clone.matrix.numpy()
    clone.to_host()
    return dict(residency=clone.residency, banks=[b.numpy() for b in clone.banks],
                matrix=matrix, device_entry_residency=e.residency)


# -- fixtures --------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    d = tmp_path_factory.mktemp("snaps")
    return str(d / "ref_device.npz"), str(d / "port_device.npz")


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory, snaps):
    out = tmp_path_factory.mktemp("ref_serving") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    arg = json.dumps([_inputs(), str(out), *snaps])
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, arg], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port(ref_proc, snaps, tmp_path_factory):
    from repro_torch.launch.mesh import spawn_world

    return spawn_world(_port_world, MU_V, workdir=tmp_path_factory.mktemp("world"),
                       device="cpu", args=(_inputs(), *snaps), timeout_s=60)


@pytest.fixture(scope="module")
def ref(ref_proc, port):
    proc, path = ref_proc
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    info = json.loads(stdout.strip().splitlines()[-1])
    with np.load(path) as z:
        arrays = {key: z[key] for key in z.files}
    return info, arrays


def _near_reference(got: dict, arrays: dict, tag: str, with_c) -> None:
    np.testing.assert_allclose(got["spread"], arrays[f"{tag}.spread"], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got["probe"], arrays[f"{tag}.probe"], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got["probe_reg"], arrays[f"{tag}.probe_reg"])
    assert np.all(np.abs(got["marginal"] - arrays[f"{tag}.marginal"])
                  <= 1e-6 * np.abs(with_c))


def _bytes_equal(a: dict, b: dict) -> None:
    for key in ("spread", "marginal", "probe", "probe_reg"):
        assert np.asarray(a[key]).tobytes() == np.asarray(b[key]).tobytes(), key


# -- queries and warm top-k ----------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_device_queries_equal_host_and_reference(name, port, ref):
    got = port[0][name]
    assert (got["residency"], got["serving"]) == ("device", "mesh:device")
    assert got["device_bytes"] == got["rows"] * J       # every placed block counted
    _bytes_equal(got["device"], got["host"])
    _near_reference(got["device"], ref[1], name, got["with_c"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_warm_top_k_from_placed_blocks(name, port, ref):
    got = port[0][name]
    for f in ("seeds", "est_gains", "scores", "rebuilds"):
        assert got["warm"][f].tobytes() == got["cold"][f].tobytes(), f
    arrays = ref[1]
    np.testing.assert_array_equal(got["warm"]["seeds"], arrays[f"{name}.seeds"])
    np.testing.assert_array_equal(got["warm"]["rebuilds"], arrays[f"{name}.rebuilds"])
    for f in ("est_gains", "scores"):
        np.testing.assert_allclose(got["warm"][f], arrays[f"{name}.{f}"], rtol=1e-6, atol=0)


# -- the mesh repair ----------------------------------------------------------------------

@pytest.mark.parametrize("i", [0, 1])
def test_mesh_repair_equals_serial_rebuild_and_reference(i, port, ref):
    """delta0 ran through the async engine while queries kept coming;
    delta1 stays inside plan shard 0."""
    info, arrays = ref
    got = port[0][MAIN][f"delta{i}"]
    rep, serial = got["rep"], got["serial"]
    want = info[f"{MAIN}.delta{i}"]
    assert rep["repair_backend"] == want["backend"] == "mesh"
    assert serial["repair_backend"] == "serial" and got["residency"] == "device"
    assert not rep["rebuilt"] and rep["repair_sweeps"] > 0
    assert got["m"].tobytes() == got["serial_m"].tobytes() == got["rebuilt_m"].tobytes()
    assert got["m"].tobytes() == arrays[f"{MAIN}.delta{i}.m"].tobytes()
    assert rep["repair_sweeps"] == serial["repair_sweeps"] == want["sweeps"]
    assert list(rep["shards_swept"]) == list(serial["shards_swept"]) == want["swept"]
    assert list(rep["plan_shards_touched"]) == want["touched"]
    assert rep["banks_touched"] == serial["banks_touched"] == want["banks"]
    if i == 1:
        assert list(rep["plan_shards_touched"]) == [0]
        # a merge runs only where the block's owner is dirty: fewer than if
        # every ring step of every sweep merged (the first sweep reads shard 0)
        done, unrestricted = got["merges"]
        assert 0 < done < unrestricted


def test_removal_then_top_k_rebuilds_and_places_again(port, ref):
    info, arrays = ref
    got = port[0][MAIN]["delta2"]
    assert got["rep"]["removed"] == 2 and not got["rep"]["rebuilt"]
    assert got["stale"] and got["residency"] == "device"
    want = info[f"{MAIN}.delta2"]
    assert want["stale"] and want["residency"] == "device"
    assert not got["after_stale"] and got["after_residency"] == "device"
    for f in ("seeds", "est_gains", "scores", "rebuilds"):
        assert got["warm"][f].tobytes() == got["cold"][f].tobytes(), f
    np.testing.assert_array_equal(got["warm"]["seeds"], arrays[f"{MAIN}.delta2.seeds"])
    assert got["rebuilt_m"].tobytes() == got["fresh_m"].tobytes()
    assert got["rebuilt_m"].tobytes() == arrays[f"{MAIN}.delta2.rebuilt_m"].tobytes()


def test_lt_delta_rebuilds_and_places_again(port, ref):
    info, arrays = ref
    name = "block_fm_mean_lt"
    got = port[0][name]["delta0"]
    assert got["rep"]["rebuilt"] and got["residency"] == "device"
    assert info[f"{name}.delta0"]["rebuilt"]
    assert got["m"].tobytes() == got["rebuilt_m"].tobytes()
    assert got["m"].tobytes() == arrays[f"{name}.delta0.m"].tobytes()


def test_mesh_repair_of_a_tensor_spmd(port):
    """Before the serving world: every rank repairs the same plan-order
    tensor on the mesh; equal to the serial repair of the same delta."""
    from repro_torch.core.difuser import DiFuserConfig
    from repro_torch.launch.common import make_graph
    from repro_torch.partition import plan_partition
    from repro_torch.partition.serial import repair_plan_shards
    from repro_torch.service import SketchStore

    inp = _inputs()
    cfg = DiFuserConfig(num_registers=J, seed=SEED)
    e = SketchStore(device="cpu").get_or_build(make_graph(GRAPH, "0.1", 0), cfg)
    plan = plan_partition(e.graph, MU_V, mu_s=1, strategy="degree", x=e.x, seed=SEED,
                          device="cpu")
    e.plan = plan
    d0 = _delta(inp["deltas"][MAIN][0])
    touched = tuple(np.unique(plan.owner_of(np.concatenate([d0.add_src, d0.add_dst]))).tolist())
    want = repair_plan_shards(e.graph.apply_delta(d0).sorted_by_dst(), cfg, e.x,
                              e.planned_matrix(), plan, touched)
    for rank in port:
        m, sweeps, swept = rank["spmd"]
        assert m.tobytes() == want[0].numpy().tobytes()
        assert (sweeps, swept) == (want[1], want[2])


# -- routing -----------------------------------------------------------------------------

def _host_entry():
    from repro_torch.core.difuser import DiFuserConfig
    from repro_torch.launch.common import make_graph
    from repro_torch.partition import plan_partition
    from repro_torch.service import SketchStore

    e = SketchStore(device="cpu").get_or_build(make_graph(GRAPH, "0.1", 0),
                                               DiFuserConfig(num_registers=J, seed=SEED))
    e.plan = plan_partition(e.graph, MU_V, mu_s=1, x=e.x, seed=SEED, device="cpu")
    return e


def test_host_entries_never_repair_on_mesh():
    from repro_torch.runtime import get_backend
    from repro_torch.service.delta import _shard_repair_backend

    e = _host_entry()
    assert _shard_repair_backend(get_backend("mesh"), e).name == "serial"
    assert _shard_repair_backend("mesh", e).name == "serial"
    assert _shard_repair_backend("auto", e).name == "serial"
    assert _shard_repair_backend(None, e) is None
    assert _shard_repair_backend("single", e) is None


def test_runspec_residency_resolution():
    from repro.runtime import RunSpec as RSpec
    from repro.runtime import get_backend as r_backend
    from repro.runtime import resolve_residency as r_resolve
    from repro_torch.runtime import RunSpec, get_backend, resolve_residency

    assert RunSpec().residency == RSpec().residency == "auto"
    for residency in ("auto", "host", "device"):
        for name in ("single", "serial", "mesh"):
            assert resolve_residency(RunSpec(residency=residency), get_backend(name)) == \
                r_resolve(RSpec(residency=residency), r_backend(name)), (residency, name)


@pytest.mark.parametrize("name", ["single", "serial", "mesh"])
def test_capabilities_match_reference(name):
    """Field by field; the description names each package's runtime."""
    import dataclasses

    from repro.runtime import get_backend as r_backend
    from repro_torch.runtime import get_backend

    got, want = get_backend(name).capabilities(), r_backend(name).capabilities()
    fields = {f.name for f in dataclasses.fields(want)} - {"description"}
    assert fields == {f.name for f in dataclasses.fields(got)} - {"description"}
    for f in sorted(fields):
        assert getattr(got, f) == getattr(want, f), f


def test_session_places_its_entry_itself(port):
    got = port[0]["session"]
    assert got["residency"] == "device" and got["plan_mu_v"] == 2
    assert tuple(got["mesh"]) == (2, 1)
    np.testing.assert_array_equal(got["warm"], got["cold"])
    assert got["cold_backend"] == "mesh" and got["repair"] == "mesh"
    assert got["pinned_mesh"]     # a session's own (mu_v, 1) mesh serves its plan


def test_two_banks_are_column_slices_of_the_placed_blocks(port):
    got = port[0]["two_banks"]
    assert got["shapes"] == [(got["rows"], J // 2)] * 2
    _bytes_equal(got["device"], got["host"])
    assert got["rep"]["repair_backend"] == "mesh" and got["serial"]["repair_backend"] == "serial"
    for f in ("repair_sweeps", "shards_swept", "banks_touched"):
        assert got["rep"][f] == got["serial"][f], f
    assert got["m"].tobytes() == got["serial_m"].tobytes()


def test_entry_of_a_graph_the_followers_lack(port):
    """The followers hold only the graph they were started with; an entry
    of another graph reaches them, whole, when it is first shared."""
    got = port[0]["new_graph"]
    np.testing.assert_array_equal(got["warm"], got["cold"])


# -- preconditions and lifecycle ---------------------------------------------------------

def test_place_on_mesh_preconditions(port):
    refused = port[0][MAIN]["refused"]
    assert "attach a partition plan" in refused["no_plan"]
    assert "mu_v=2" in refused["mu_v"] and "4-way" in refused["mu_v"]
    assert "shard rows only" in refused["sim_axis"]
    bare = _host_entry()
    bare.plan = None
    with pytest.raises(ValueError, match="plan"):
        bare.place_on_mesh(mesh=None)
    assert bare.residency == "host" and bare.serving_backend == "single:host"
    assert bare.to_host() is bare


def test_make_mesh_on_the_controller_raises(port):
    assert "Controller.make_mesh" in port[0][MAIN]["spmd_mesh_on_controller"]


def test_device_entries_refuse_attach_plan_and_eviction(port):
    got = port[0][MAIN]
    assert "device-resident" in got["refused"]["attach_plan"]
    assert "not evictable" in got["refused"]["evict"]
    assert got["evictor_victims"] == [] and not got["evictor_evictable"]


def test_to_host_gives_back_the_canonical_banks(port):
    got = port[0][MAIN]["to_host"]
    assert got["residency"] == "host" and got["device_entry_residency"] == "device"
    assert len(got["banks"]) == 1
    assert got["banks"][0].tobytes() == got["matrix"].tobytes()


def test_a_stopped_mesh_raises(port):
    assert "serving world" in port[0]["after_stop"]


# -- snapshots ----------------------------------------------------------------------------

def test_snapshots_load_in_both_directions(port, ref, snaps):
    info, arrays = ref
    got = port[0]
    z = np.load(snaps[1])
    assert str(z["residency"]) == "device" and "plan_perm" in z.files
    # the reference's device snapshot, placed on the port's mesh: the same
    # matrix, so the port's own answers byte for byte
    assert got["ref_snap"]["residency"] == "device"
    _bytes_equal(got["ref_snap"]["answers"], got[MAIN]["device"])
    _near_reference(got["ref_snap"]["answers"], arrays, MAIN, got[MAIN]["with_c"])
    # the port's device snapshot, placed on the reference's 4 fake devices
    _near_reference(got[MAIN]["device"], arrays, "port_snap", got[MAIN]["with_c"])


def test_device_snapshot_without_a_mesh_warns_and_serves_host_order(port):
    got = port[0]["port_snap_meshless"]
    assert got["residency"] == "host"
    assert any("load(mesh=...)" in w for w in got["warned"])
    _bytes_equal(got["answers"], port[0][MAIN]["device"])


# -- the async engine ---------------------------------------------------------------------

def test_async_engine_on_a_placed_entry_with_a_delta_in_flight(port):
    got = port[0][MAIN]
    assert got["sync_equals_host"]
    assert got["engine_backends"] == ["mesh:device"]
    a = got["async"]
    assert a["first"] and a["during"] and a["after"]
    assert got["version_n_kept"]      # the shadow's repair left version N's blocks


# -- the ranks and the exchange -----------------------------------------------------------

def test_ranks_run_only_plain_versions(port):
    assert port[0]["world"] == MU_V
    for rank, got in enumerate(port):
        launches, plain = got["counters"]
        assert launches == {}, (rank, launches)
        assert PATH_KERNELS <= set(plain), (rank, plain)
        if rank:
            assert set(plain) <= PATH_KERNELS, (rank, plain)


def test_exchange_counts_the_serving_kinds(port):
    ex = port[0]["exchange"]
    for kind in ("all_reduce_max", "scatter", "gather", "ring_shift", "all_gather"):
        assert ex[kind]["calls"] > 0, kind
    assert ex["scatter"]["bytes_sent"] > 0


# -- the front door -----------------------------------------------------------------------

SERVE_ARGS = ["--graph", GRAPH, "--registers", str(J), "--queries", "64", "--topk", str(K),
              "--device", "cpu"]


def test_serve_residency_device_under_torchrun(tmp_path):
    from repro_torch.launch import serve_im

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch", "serve", *SERVE_ARGS,
           "--residency", "device", "--plan-shards", "2",
           "--answers", str(tmp_path / "device.json")]
    proc = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    placed = [ln for ln in lines if ln.startswith("device-resident: 2 row blocks x ")]
    assert len(placed) == 1, proc.stdout
    assert placed[0].endswith(" B on mesh {'data': 2, 'model': 1} (serving mesh:device)")
    assert any(ln.startswith("cold find_seeds [mesh]:") for ln in lines), proc.stdout
    assert sum(ln.startswith("graph n=") for ln in lines) == 1     # rank 0 alone prints
    host = serve_im.run(SERVE_ARGS + ["--residency", "host",
                                      "--answers", str(tmp_path / "host.json")])
    assert (host["residency"], host["serving"]) == ("host", "single:host")
    assert json.loads((tmp_path / "device.json").read_text()) == \
        json.loads((tmp_path / "host.json").read_text())


def test_serve_residency_device_without_a_group_raises():
    import torch.distributed as dist

    from repro_torch.launch import serve_im
    from repro_torch.runtime import BackendUnavailable

    assert not dist.is_initialized()
    with pytest.raises(BackendUnavailable, match="no process group"):
        serve_im.run(SERVE_ARGS + ["--residency", "device", "--plan-shards", "2"])
