"""The port's dry run (``launch/dryrun.py``, ``utils/{roofline,collectives,
opprof}.py``, ``kernels/cost.py``, the ``meta`` branch of ``kernels/ops.py``,
``launch/mesh.py``'s ``make_production_mesh`` and ``DryExchange``) against
the reference's, on the CPU.

The reference's dry run lowers and compiles its mesh program in one
subprocess (its ``launch.dryrun`` module sets 512 fake XLA devices when
imported): the mini cell of ``tests/test_hlo_and_dryrun.py`` on four meshes
and livejournal on the 16 x 16 production mesh. The port's collective-permute
bytes, and its block all-gathers under the allgather schedule, equal the
reference's compiled program's; the other kinds are held to the port's own
schedule. One gloo world of 4 ranks runs the mesh backend under both
schedules: the dry program of each rank-0 partition, times the run's sweep
counts, equals the run's exchanges and plain calls.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.utils import hlo as R_hlo
from repro.utils import roofline as R_roofline
from repro_torch.kernels import counters, ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import DryGroup, MeshShape, dry_mesh, make_production_mesh
from repro_torch.utils import collectives, opprof, roofline

ROOT = Path(__file__).resolve().parents[1]
MINI = (1 << 12, 1 << 14, 64, 1.5)
#: tag -> (shape, axes, schedule, cell)
CELLS = {
    "mini_2x2_ring": ((2, 2), ("data", "model"), "ring", "mini"),
    "mini_2x2_allgather": ((2, 2), ("data", "model"), "allgather", "mini"),
    "mini_4x2_ring": ((4, 2), ("data", "model"), "ring", "mini"),
    "mini_2x2x2_ring": ((2, 2, 2), ("pod", "data", "model"), "ring", "mini"),
    "livejournal_pod16x16": ((16, 16), ("data", "model"), "ring", "difuser-livejournal"),
}
RECORD_KEYS = {"arch", "shape", "mesh", "ok", "compile_s", "flops", "bytes_accessed",
               "wire_bytes", "memory", "collectives", "chips"}

REF_SCRIPT = r"""
import json, sys
from repro.launch.dryrun import IM_CELLS, run_cell
from repro.launch.mesh import make_mesh

cells, mini = json.loads(sys.argv[1])
IM_CELLS["mini"] = tuple(mini)
out = {}
for tag, (shape, axes, schedule, cell) in cells.items():
    out[tag] = run_cell(cell, make_mesh(tuple(shape), tuple(axes)), tag, schedule=schedule)
print(json.dumps(out))
"""


# -- the roofline and the ring formulas ---------------------------------------------

def test_roofline_terms_on_the_h100_roofs():
    r = roofline.Roofline(arch="x", shape="im_step", mesh="m", chips=256,
                          flops_per_device=roofline.INT32_OPS,
                          bytes_per_device=2 * roofline.HBM_BW,
                          wire_bytes_per_device=0.5 * roofline.LINK_BW,
                          model_flops_total=roofline.INT32_OPS * 256)
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 2.0, 0.5)
    assert r.bottleneck == "memory" and r.t_bound == 2.0
    assert r.useful_flops_ratio == 1.0 and r.roofline_fraction == 0.5
    assert roofline.HBM_BW == 3.35e12 and roofline.LINK_BW == 450e9
    assert abs(roofline.INT32_OPS - 16.7e12) < 0.05e12
    ref = R_roofline.Roofline(arch="x", shape="im_step", mesh="m", chips=256,
                              flops_per_device=1.0, bytes_per_device=1.0,
                              wire_bytes_per_device=1.0, model_flops_total=1.0)
    assert list(r.to_dict()) == list(ref.to_dict())


class _Cfg:
    def active_param_count(self):
        return 7_123_456_789


class _Shape:
    def __init__(self, kind):
        self.kind, self.global_batch, self.seq_len = kind, 48, 4096


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_matches_reference(kind):
    assert roofline.model_flops(_Cfg(), _Shape(kind)) == R_roofline.model_flops(
        _Cfg(), _Shape(kind))


#: exchange kind -> (the reference's HLO line of the same collective, or None)
FORMULA_CASES = {
    "all_reduce": ("%all-reduce.1 = s64[1]{0} all-reduce(s64[1]{0} %x), "
                   "replica_groups={{0,1,2,3}}, to_apply=%add"),
    "all_reduce_max": ("%all-reduce.2 = s8[64,32]{1,0} all-reduce(s8[64,32]{1,0} %x), "
                       "replica_groups=[1,4]<=[4], to_apply=%max"),
    "all_gather": ("%all-gather = f32[4,2,128]{2,1,0} all-gather(f32[1,2,128]{2,1,0} %p), "
                   "replica_groups=[1,4]<=[4], dimensions={0}"),
    # the selection's psum of the (2, n_loc) float32 sums over the sim shards
    "ordered_sum": ("%all-reduce.3 = f32[2,128]{1,0} all-reduce(f32[2,128]{1,0} %s), "
                    "replica_groups=[1,4]<=[4], to_apply=%add"),
    "ring_shift": ("%collective-permute = s8[64,32]{1,0} collective-permute(s8[64,32]{1,0} "
                   "%q), source_target_pairs={{0,1},{1,0}}"),
    "scatter": None,
    "gather": None,
}


@pytest.mark.parametrize("kind", sorted(FORMULA_CASES))
def test_ring_formula_of_each_kind(kind):
    """A dry exchange's records through ``collective_stats``, against the
    reference's parser on the same collective (scatter and gather, which
    the reference's program has not, against ``B * (N-1)/N``)."""
    ex = dry_mesh(MeshShape((4, 1), ("data", "model"))).exchange
    grid4 = DryGroup(4)
    calls = {
        "all_reduce": lambda: ex.all_reduce(3, None, grid4),
        "all_reduce_max": lambda: ex.all_reduce_max(
            torch.empty((64, 32), dtype=torch.int8, device="meta"), grid4),
        "all_gather": lambda: ex.all_gather(
            torch.empty((2, 128), dtype=torch.float32, device="meta"), grid4, 4),
        "ordered_sum": lambda: ex.ordered_sum(
            torch.empty((2, 128), dtype=torch.float32, device="meta"), grid4, 4),
        "ring_shift": lambda: ex.ring_shift(
            torch.empty((64, 32), dtype=torch.int8, device="meta"),
            torch.empty((64, 32), dtype=torch.int8, device="meta"), send_to=1, recv_from=1),
        "scatter": lambda: ex.scatter(
            [torch.empty((8, 32), dtype=torch.int8, device="meta")] * 4,
            torch.empty((8, 32), dtype=torch.int8, device="meta"), grid4),
        "gather": lambda: ex.gather(torch.empty((8, 32), dtype=torch.int8, device="meta"),
                                    grid4, dst=1),
    }
    calls[kind]()
    got = collectives.collective_stats(ex.records)
    assert got.op_count == 1 and set(got.to_dict()) == {"wire_bytes", "by_kind", "op_count"}
    if FORMULA_CASES[kind] is not None:
        want = R_hlo.collective_stats(FORMULA_CASES[kind])
        assert got.by_kind == dict(want.by_kind) and got.wire_bytes == want.wire_bytes
    else:
        assert got.by_kind == {kind: 4 * 8 * 32 * 3 / 4}
    # the dry exchange counts as the real one does: a call and the bytes sent
    (calls_, sent, secs), = ex.stats.values()
    assert calls_ == 1 and secs == 0.0
    assert sent == {"all_reduce": 8, "all_reduce_max": 2048, "all_gather": 1024,
                    "ordered_sum": 1024, "ring_shift": 2048, "scatter": 768,
                    "gather": 256}[kind]


def test_production_mesh_and_the_dry_rank_view():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (single.shape, single.axis_names, single.mu_v, single.mu_s, single.size) == (
        (16, 16), ("data", "model"), 16, 16, 256)
    assert (multi.shape, multi.axis_names, multi.mu_v, multi.mu_s, multi.size) == (
        (2, 16, 16), ("pod", "data", "model"), 16, 32, 512)
    mesh = dry_mesh(multi, (3, 5))
    assert mesh.axis_names == ("data", "pod", "model") and mesh.shape == (16, 2, 16)
    assert (mesh.mu_v, mesh.mu_s, mesh.rank, mesh.device.type) == (16, 32, 3 * 32 + 5,
                                                                  "meta")
    assert (mesh.vertex_group.size, mesh.sim_group.size, mesh.grid_group.size) == (16, 32,
                                                                                  512)


def test_op_profile_reads_self_cpu_time_without_cuda_activity():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        a = torch.ones((256, 256))
        for _ in range(3):
            a = (a @ a).clamp_(max=1.0)
    total, rows = opprof.op_profile(prof, top=3)
    assert total > 0 and 0 < len(rows) <= 3
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)
    assert all(0 < share <= 1 for share, _, _, _ in rows)
    assert any("mm" in name for _, _, _, name in rows)
    assert opprof.device_busy_us(prof) == 0.0


# -- the meta branch of kernels.ops -------------------------------------------------

def _operands(device):
    from repro_torch.kernels.edges import EdgeOperands, group_rows, with_work

    rng = np.random.default_rng(7)
    n, j, e = 64, 32, 300
    m = torch.from_numpy(rng.integers(-1, 20, (n, j), dtype=np.int8)).to(device)
    src, dst = (rng.integers(0, n, e, dtype=np.int32) for _ in range(2))
    h, lo, thr = (rng.integers(0, 2**32, e, dtype=np.uint32) for _ in range(3))
    edges = EdgeOperands.from_numpy(src, dst, h, lo, thr, n, "cpu")
    x = torch.from_numpy(rng.integers(0, 2**32, j, dtype=np.uint32).view(np.int32))
    if device == "meta":
        edges = _to_meta(edges)
    x = x.to(device)
    bits = torch.from_numpy(h.view(np.int32)).to(device)
    rows = with_work(group_rows(torch.from_numpy(src), torch.from_numpy(dst),
                                *(torch.from_numpy(a.view(np.int32)) for a in (h, lo, thr)),
                                n))
    if device == "meta":
        rows = _to_meta(rows)
    return m, edges, rows, x, bits


def _to_meta(obj):
    """A dataclass of tensors (nested) with every tensor on ``meta``."""
    import dataclasses

    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to("meta")
        elif dataclasses.is_dataclass(v):
            v = _to_meta(v)
        kw[f.name] = v
    return dataclasses.replace(obj, **kw)


CALLS = {
    "sketch_fill": lambda m, edges, rows, x, bits: ops.sketch_fill(m, reg_offset=3),
    "sketch_cardinality": lambda m, edges, rows, x, bits: ops.cardinality_stats(m),
    "sketch_propagate": lambda m, edges, rows, x, bits: ops.propagate_sweep(
        m, edges, x, variant=0),
    "cascade_step": lambda m, edges, rows, x, bits: ops.cascade_sweep(
        m, edges, x, variant=1),
    "fused_sample": lambda m, edges, rows, x, bits: ops.fused_sample(
        bits, bits, bits, x, variant=0),
    "fused_sweep": lambda m, edges, rows, x, bits: ops.fused_sweep(
        m, rows, x, variant=0, num_sweeps=2),
    "bucket_propagate": lambda m, edges, rows, x, bits: ops.bucket_propagate(
        m, m.clone(), rows, x, variant=0),
    "bucket_cascade": lambda m, edges, rows, x, bits: ops.bucket_cascade(
        m, m.clone(), rows, x, variant=0),
}


def _shapes(out):
    out = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in out]


@pytest.mark.parametrize("name", sorted(CALLS))
def test_ops_on_meta_take_the_shape_function(name):
    counters.reset()
    want = _shapes(CALLS[name](*_operands("cpu")))
    assert dict(counters.PLAIN_CALLS) == {name: 1}
    counters.reset()
    out = CALLS[name](*_operands("meta"))
    assert _shapes(out) == want
    assert all(t.device.type == "meta" for t in (out if isinstance(out, tuple) else (out,)))
    assert dict(counters.DRY_LAUNCHES) == {name: 1}
    assert not counters.LAUNCHES and not counters.PLAIN_CALLS
    assert counters.DRY_OPS[name] > 0 and counters.DRY_BYTES[name] > 0


# -- the dry counts against a real run ----------------------------------------------

def _real_and_dry(rank):
    """Both schedules on one rank of the world: the real run's exchanges and
    plain calls, and the dry program of its partition, scaled by its counts."""
    from repro_torch.launch.common import make_graph
    from repro_torch.runtime import RunSpec, run

    g = make_graph("rmat:9", "0.1", 0)
    out = {}
    for schedule in ("ring", "allgather"):
        spec = RunSpec(backend="mesh", num_registers=32, mu_v=2, mu_s=2, schedule=schedule)
        counters.reset()
        rep = run(g, 3, spec, device="cpu")
        plain = dict(counters.PLAIN_CALLS)
        pred = dryrun.dry_program(rep.partition, spec.distributed_config(), k=3,
                                  coord=(rank // 2, rank % 2)).for_run(rep.result)
        out[schedule] = dict(
            real={k: (v["calls"], v["bytes_sent"])
                  for k, v in rep.result.stats["exchange"].items()},
            dry={k: (v["calls"], v["bytes_sent"]) for k, v in pred.summary().items()},
            plain=plain, launches=dict(pred.launches),
            sweeps=(rep.result.propagate_iters, rep.result.stats["cascade_sweeps"],
                    rep.result.stats["rebuild_sweeps"]))
    return out


@pytest.fixture(scope="module")
def real_world(tmp_path_factory, reference_process):
    from repro_torch.launch.mesh import spawn_world

    return spawn_world(_real_and_dry, 4, workdir=tmp_path_factory.mktemp("dry_world"),
                       device="cpu", timeout_s=300)


@pytest.mark.parametrize("schedule", ["ring", "allgather"])
def test_dry_counts_times_the_sweeps_equal_a_real_run(schedule, real_world):
    for rank, res in enumerate(real_world):
        r = res[schedule]
        assert all(r["sweeps"]), r["sweeps"]
        assert r["dry"] == r["real"], (rank, r)
        # the partition's sampling (fused_sample) runs before the rank program
        program = {k: v for k, v in r["plain"].items() if k != "fused_sample"}
        assert r["launches"] == program, (rank, r)


# -- the port's dry run against the reference's compiled program --------------------

@pytest.fixture(scope="module")
def reference_process():
    """The reference's dry run, started once and left running while the
    gloo world (``real_world``) runs."""
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, json.dumps([CELLS, MINI])],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference_records(reference_process):
    out, err = reference_process.communicate(timeout=600)
    assert reference_process.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture
def mini_cell(monkeypatch):
    monkeypatch.setitem(dryrun.IM_CELLS, "mini", MINI)


def _port_schedule(grid: MeshShape, cell: str, schedule: str) -> dict:
    """The port's wire bytes by kind, from its schedule: three ring-sweep
    bodies (build, cascade, rebuild), one round's select (the ordered sum of
    the sim shards' ``(2, n_loc)`` float32 sums, an all-reduce's bytes of
    the sums padded to ``mu_s`` equal chunks, then the vertex shards'
    float64 argmax pairs) and four int64 all-reduces (three changed flags,
    the visited count) over the grid."""
    n, _, j, _ = dryrun.IM_CELLS[cell]
    mu_v, mu_s, size = grid.mu_v, grid.mu_s, grid.size
    n_loc = -(-n // mu_v)
    block = n_loc * (j // mu_s)
    sums = mu_s * -(-2 * n_loc // mu_s) * 4
    out = {"all-reduce": 4 * 2.0 * 8 * (size - 1) / size + 2.0 * sums * (mu_s - 1) / mu_s,
           "all-gather": 16 * (mu_v - 1)}
    if schedule == "ring":
        out["collective-permute"] = 3.0 * (mu_v - 1) * block
    else:
        out["all-gather"] += 3.0 * block * (mu_v - 1)
    return out


@pytest.mark.parametrize("tag", sorted(CELLS))
def test_port_against_the_reference_dry_run(tag, reference_records, mini_cell):
    shape, axes, schedule, cell = CELLS[tag]
    grid = MeshShape(shape, axes)
    ref = reference_records[tag]
    assert ref["ok"], ref.get("error")
    rec = dryrun.run_cell(cell, grid, tag, schedule=schedule)
    assert rec["ok"], rec.get("traceback")
    assert set(rec) == set(ref) == RECORD_KEYS
    assert set(rec["memory"]) == set(ref["memory"])
    assert rec["chips"] == ref["chips"] == grid.size
    got, want = rec["collectives"]["by_kind"], ref["collectives"]["by_kind"]
    prog, part = dryrun.lower_im_cell(cell, grid, schedule=schedule)
    if schedule == "ring":
        assert got["collective-permute"] == want["collective-permute"]
    else:   # the block gathers alone: the reference's all-gather less its argmax's
        records = prog.total().records
        block = [r for r in records if r.kind == "all_gather"
                 and r.shape == (part.n_loc, part.j_loc)]
        blocks = collectives.collective_stats(block).wire_bytes
        assert len(block) == 3 and blocks == want["all-gather"] - 8
    assert got == pytest.approx(_port_schedule(grid, cell, schedule), rel=1e-12), (
        f"port {got}, the reference's {want}")
    # the selection's sum moves the reference's psum bytes, within 10 %
    assert abs(got["all-reduce"] - want["all-reduce"]) <= 0.1 * want["all-reduce"]
    assert rec["wire_bytes"] == rec["collectives"]["wire_bytes"]
    assert rec["wire_bytes"] == pytest.approx(sum(got.values()), rel=1e-12)


#: each production record's dry temp bytes before the owned-rows fill, when a
#: rank filled the whole ``n_pad x j_loc`` matrix and its fill and then
#: selected its rows (the port's dry run at commit 79c500f)
WHOLE_FILL_TEMP_GB = {("difuser-livejournal", False): 2.148, ("difuser-twitter", False): 8.594,
                      ("difuser-friendster", False): 17.184,
                      ("difuser-livejournal", True): 1.074, ("difuser-twitter", True): 4.299,
                      ("difuser-friendster", True): 8.594}


def test_fill_transient_shows_in_temp_bytes():
    """A rank fills only the ``n_loc`` rows it owns, keyed on their original
    ids (``sketch_fill``'s row-id operand): no ``n_pad``-row matrix lives on
    it. At twitter on the 16 x 16 mesh its temp is a few 268 MB blocks
    (the fill, the block, the ring's two buffers, a sweep's copy), not the
    2 x 4.29 GB of the whole matrix and its fill; every production record's
    temp is at most a quarter of the whole fill's."""
    prog, part = dryrun.lower_im_cell("difuser-twitter", make_production_mesh())
    assert part.n_pad * part.j_loc == 1 << 32
    block = part.n_loc * part.j_loc
    assert block == 1 << 28
    assert 4 * block <= prog.temp_bytes <= 8 * block < part.n_pad * part.j_loc
    assert prog.temp_bytes <= 2.15e9
    assert prog.bodies["fill"].launches == {"sketch_fill": 1}
    # the fill's bytes: the owned block read and written, one int64 id a row
    assert prog.bodies["fill"].kernel_bytes == 2 * block + 8 * part.n_loc
    for (cell, multi), whole_gb in WHOLE_FILL_TEMP_GB.items():
        prog, _ = dryrun.lower_im_cell(cell, make_production_mesh(multi_pod=multi))
        assert prog.temp_bytes <= whole_gb * 1e9 / 4, (cell, multi, prog.temp_bytes)
    launched = prog.total().launches
    assert launched == {"sketch_fill": 1, "bucket_propagate": 32, "sketch_cardinality": 1,
                        "bucket_cascade": 16}


def test_front_door_writes_the_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch", "dryrun", "--arch",
                           "difuser-livejournal", "--mesh", "single", "--out", str(tmp_path)],
                          env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("[OK ] difuser-livejournal")
    rec = json.loads((tmp_path / "difuser-livejournal__im_step__pod16x16.json").read_text())
    assert rec["ok"] and set(rec) == RECORD_KEYS and rec["chips"] == 256
    assert rec["collectives"]["by_kind"]["collective-permute"] == 3 * 15 * (1 << 19) * 128


def test_help_lists_dryrun(capsys):
    from repro_torch.__main__ import main

    with pytest.raises(SystemExit) as exc:
        main(["--help"])
    assert exc.value.code == 0 and "dryrun" in capsys.readouterr().out
