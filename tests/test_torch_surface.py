"""The port's public surface against the reference's, on the CPU.

``test_every_reference_name_has_a_counterpart`` lists the public names of
every module of ``src/repro/`` (top-level functions, classes and their
public methods, and module-level names, read from the source) and asserts
that the module of the same path in ``repro_torch`` has each one, or, for a
renamed one, every counterpart ``NAME_MAP`` gives; ``EXCLUDED`` holds the
names the port leaves out by design, each with its reason. Then the surface
the earlier slices had not ported is held against the reference function:
``core/sketch.py``'s fill, union, estimators and host reference,
``core/select.py::topk_candidates`` (ties in index order), the numpy
predicates of ``core/sampling.py``, the model registry and
``DecayingIC.edge_delay``, ``graphs/io.py``'s npz cache, ``Graph`` and
``CSR``'s helpers, ``PartitionPlan.local_row_of``,
``baselines.sample_live_mask`` and ``runtime``'s ``available``. Float32
statistics to ``rtol=1e-6``; everything else exactly.
"""
import ast
import dataclasses
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"

_KERNELS = ("sketch_fill", "sketch_propagate", "cascade_step", "sketch_cardinality",
            "fused_sweep", "bucket_propagate", "fused_sample")
#: reference "module:name" -> the port's "module:name" counterparts, all of
#: which must exist
NAME_MAP = {
    # the Pallas kernels -> the CUDA kernels' wrappers
    "repro.kernels.sketch_fill:sketch_fill_pallas": (
        "repro_torch.kernels.sketch_fill:sketch_fill_cuda",),
    "repro.kernels.sketch_propagate:propagate_sweep_pallas": (
        "repro_torch.kernels.sketch_propagate:propagate_sweep_cuda",),
    "repro.kernels.cascade_step:cascade_sweep_pallas": (
        "repro_torch.kernels.cascade_step:cascade_sweep_cuda",),
    "repro.kernels.sketch_cardinality:cardinality_stats_pallas": (
        "repro_torch.kernels.sketch_cardinality:cardinality_stats_cuda",),
    "repro.kernels.fused_sweep:fused_sweep_pallas": (
        "repro_torch.kernels.fused_sweep:fused_sweep_cuda",),
    "repro.kernels.bucket_propagate:bucket_propagate_pallas": (
        "repro_torch.kernels.bucket_propagate:bucket_propagate_cuda",),
    "repro.kernels.fused_sample:fused_sample_pallas": (
        "repro_torch.kernels.fused_sample:fused_sample_cuda",),
    "repro.kernels.fused_sweep:VISITED": ("repro_torch.core.sketch:VISITED",),
    # the in-kernel jnp hashes -> the torch ones
    "repro.kernels.common:kmix32": ("repro_torch.core.sampling:t_mix32",),
    "repro.kernels.common:kregister_hash": ("repro_torch.core.sampling:t_register_hash",),
    "repro.kernels.common:kclz32": ("repro_torch.core.sampling:t_clz32",),
    # numpy-or-jnp functions -> the numpy copy and the torch version
    **{f"repro.core.sampling:{name}": (f"repro_torch.core.sampling:{name}",
                                       f"repro_torch.core.sampling:t_{name}")
       for name in ("mix32", "register_hash", "fused_predicate",
                    "remix_interval_predicate", "clz32")},
    # kernels/ref.py: each kernel module's plain version is its counterpart
    **{f"repro.kernels.ref:{ref}_ref": (f"repro_torch.kernels.{mod}:{ref}_plain",)
       for mod, ref in (("sketch_fill", "sketch_fill"), ("sketch_propagate", "propagate_sweep"),
                        ("cascade_step", "cascade_sweep"),
                        ("sketch_cardinality", "cardinality_stats"),
                        ("fused_sweep", "fused_sweep"), ("fused_sample", "fused_sample"))},
    "repro.kernels.ref:estimate_ref": ("repro_torch.core.sketch:estimate_cardinality",),
    # the TPU's roofs -> the H100's
    "repro.utils.roofline:PEAK_FLOPS": ("repro_torch.utils.roofline:INT32_OPS",),
    "repro.utils.roofline:ICI_BW": ("repro_torch.utils.roofline:LINK_BW",),
    # no HLO: the exchange's records and the profiler's op times
    "repro.utils.hlo:CollectiveStats": ("repro_torch.utils.collectives:CollectiveStats",),
    "repro.utils.hlo:CollectiveStats.to_dict": (
        "repro_torch.utils.collectives:CollectiveStats.to_dict",),
    "repro.utils.hlo:collective_stats": ("repro_torch.utils.collectives:collective_stats",),
    "repro.utils.hloprof:dot_flop_profile": ("repro_torch.utils.opprof:op_profile",),
    "repro.utils.hloprof:print_profile": ("repro_torch.utils.opprof:print_profile",),
}
_PALLAS_BODIES = ("the Pallas bodies' block shapes and padding: the CUDA kernels take "
                  "any shape (ROADMAP §1.4)")
#: reference "module:name" -> why the port leaves it out
EXCLUDED = {
    **{f"repro.kernels.common:{name}": _PALLAS_BODIES
       for name in ("REG_TILE", "EDGE_BLOCK", "VERTEX_BLOCK", "pick_block", "clamp_block",
                    "pad_amount")},
    "repro.kernels.sketch_propagate:pad_edge_operands": _PALLAS_BODIES,
    "repro.kernels.sketch_propagate:pad_register_axis": _PALLAS_BODIES,
    "repro.utils.jax_compat:JAX_HAS_AXIS_TYPE": "utils/jax_compat.py is a jax version guard "
                                                "(ROADMAP §1.4)",
    "repro.runtime:warn_deprecated": "the reference's deprecation shims: the port has no "
                                     "deprecated entry points",
}


_KNOBS = ("the Pallas bodies' block and tiling knobs and their impl switch: the CUDA "
          "kernels take any shape and a wrapper picks its kernel by the tensor's device "
          "(ROADMAP §1.4)")
_OPERANDS = ("the edge operands (src, dst, h, lo, thr and the hash seed, or a bucket's w, "
             "r, t) travel bundled in ``kernels.edges.EdgeOperands``/``EdgeRows``, and the "
             "predicate as the kernels' compiled-in ``variant``")
_EDGES = ("src", "dst", "thr", "h", "lo", "seed", "predicate")
#: where a reference parameter has no counterpart of its name: ``"*"`` for
#: parameters left out wherever they appear, else ``"module:name"`` (the
#: reference's) -> (its parameters left out, why)
PARAM_EXCLUDED = {
    "*": (("impl", "edge_block", "reg_tile", "edge_chunk", "cascade_chunk", "default_chunk",
           "vertex_block", "lane_tile", "interpret"), _KNOBS),
    **{key: (_EDGES, _OPERANDS) for key in (
        "repro.core.cascade:cascade_from_seed", "repro.core.simulate:propagate_to_fixpoint",
        "repro.kernels.ops:propagate_sweep", "repro.kernels.ops:cascade_sweep",
        "repro.kernels.ops:fused_sweep",
        "repro.kernels.sketch_propagate:propagate_sweep_pallas",
        "repro.kernels.cascade_step:cascade_sweep_pallas",
        "repro.kernels.fused_sweep:fused_sweep_pallas",
        "repro.kernels.ref:propagate_sweep_ref", "repro.kernels.ref:cascade_sweep_ref",
        "repro.kernels.ref:fused_sweep_ref")},
    **{key: (("src", "dst", "seed", "predicate"), _OPERANDS) for key in (
        "repro.kernels.ops:fused_sample", "repro.kernels.fused_sample:fused_sample_pallas",
        "repro.kernels.ref:fused_sample_ref")},
    "repro.kernels.bucket_propagate:bucket_propagate_pallas": (
        ("h", "w", "r", "t", "lo", "predicate"), _OPERANDS),
    "repro.kernels.common:kregister_hash": (
        ("vertex", "reg"), "the in-kernel hash's torch twin takes the kernels' operand names "
                           "(u, j); the numpy ``register_hash`` keeps the reference's"),
    **{f"repro.core.distributed:{name}": (
        ("planned_m",), "a rank holds its block of the plan-order matrix, ``planned_block``, "
                        "where the reference's single controller holds the whole matrix")
       for name in ("find_seeds_warm_distributed", "repair_plan_shards_distributed")},
    **{f"repro.launch.dryrun:{name}": (
        ("mesh",), "the dry run takes the grid's shape (``grid``, a ``MeshShape``) where "
                   "the reference takes a jax ``Mesh`` of fake devices")
       for name in ("lower_im_cell", "run_cell")},
    **{key: (("hlo_text",), "no HLO: the collective stats read the exchange's records and "
                            "the op profile a ``torch.profiler`` run")
       for key in ("repro.utils.hlo:collective_stats", "repro.utils.hloprof:dot_flop_profile",
                   "repro.utils.hloprof:print_profile")},
}


def _public_names(path: Path) -> list:
    """The public names a reference module defines: top-level functions and
    classes (and the classes' public methods) and module-level names."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{sub.name}" for sub in node.body
                          if isinstance(sub, ast.FunctionDef) and not sub.name.startswith("_")]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets
                      if isinstance(t, ast.Name) and not t.id.startswith("_")
                      and t.id != "__all__"]
        elif (isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name)
              and not node.target.id.startswith("_")):
            names.append(node.target.id)
    return names


def _reference_surface() -> dict:
    """``"module:name"`` of every public name of ``src/repro/``, and of its
    packages' ``__all__``."""
    out = {}
    for path in sorted(REF.rglob("*.py")):
        parts = [p for p in path.relative_to(REF).with_suffix("").parts if p != "__init__"]
        mod = ".".join(["repro", *parts])
        for name in _public_names(path):
            out[f"{mod}:{name}"] = mod
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
                for elt in node.value.elts:
                    out[f"{mod}:{elt.value}"] = mod
    return out


def _has(path: str) -> bool:
    mod, name = path.split(":")
    try:
        obj = importlib.import_module(mod)
    except ModuleNotFoundError:
        return False
    for attr in name.split("."):
        if not hasattr(obj, attr):
            return False
        obj = getattr(obj, attr)
    return True


def test_every_reference_name_has_a_counterpart():
    surface = _reference_surface()
    assert len(surface) > 300
    missing = []
    for key in surface:
        if key in EXCLUDED:
            continue
        targets = NAME_MAP.get(key, ("repro_torch" + key[len("repro"):],))
        missing += [f"{key} -> {t}" for t in targets if not _has(t)]
    assert not missing, "\n".join(missing)


def test_the_map_and_the_exclusions_are_all_needed():
    """Every excluded name exists in the reference and not in the port;
    every mapped name exists in the reference, and every kernel module's
    Pallas entry is mapped."""
    surface = _reference_surface()
    for key in EXCLUDED:
        assert key in surface and not _has("repro_torch" + key[len("repro"):]), key
    for key in NAME_MAP:
        assert key in surface, key
    assert sum(key.endswith("_pallas") for key in NAME_MAP) == len(_KERNELS)


def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs if p.arg not in ("self", "cls")]


def _decorated(node, names) -> bool:
    for d in node.decorator_list:
        d = d.func if isinstance(d, ast.Call) else d
        if (d.attr if isinstance(d, ast.Attribute) else getattr(d, "id", "")) in names:
            return True
    return False


def _reference_parameters() -> dict:
    """``"module:name"`` -> the parameter names of every public function and
    public method of ``src/repro/``, and a public class's constructor
    parameters (its dataclass or NamedTuple fields and ``__init__``'s),
    read from the source; private fields and properties are left out."""
    out = {}
    for path in sorted(REF.rglob("*.py")):
        parts = [p for p in path.relative_to(REF).with_suffix("").parts if p != "__init__"]
        mod = ".".join(["repro", *parts])
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or node.name.startswith("_"):
                continue
            if isinstance(node, ast.FunctionDef):
                out[f"{mod}:{node.name}"] = _params(node)
            elif isinstance(node, ast.ClassDef):
                fields = []
                if _decorated(node, ("dataclass",)) or any(
                        getattr(b, "id", None) == "NamedTuple" for b in node.bases):
                    fields = [a.target.id for a in node.body if isinstance(a, ast.AnnAssign)
                              and isinstance(a.target, ast.Name)
                              and not a.target.id.startswith("_")]
                for sub in node.body:
                    if not isinstance(sub, ast.FunctionDef):
                        continue
                    if sub.name == "__init__":
                        fields += _params(sub)
                    elif not sub.name.startswith("_") and not _decorated(
                            sub, ("property", "setter", "cached_property")):
                        out[f"{mod}:{node.name}.{sub.name}"] = _params(sub)
                if fields:
                    out[f"{mod}:{node.name}"] = fields
    return out


def _port_parameters(path: str) -> set:
    """The parameter names the port's counterpart takes: its signature's and,
    for a dataclass or NamedTuple, its fields."""
    mod, name = path.split(":")
    obj = importlib.import_module(mod)
    for attr in name.split("."):
        obj = getattr(obj, attr)
    names = set(inspect.signature(obj).parameters)
    if dataclasses.is_dataclass(obj):
        names |= {f.name for f in dataclasses.fields(obj)}
    return names | set(getattr(obj, "_fields", ()))


def _excluded_parameters(key: str) -> set:
    return set(PARAM_EXCLUDED["*"][0]) | set(PARAM_EXCLUDED.get(key, ((), ""))[0])


def test_every_reference_parameter_has_a_counterpart():
    """Each parameter and field of the reference's public functions, methods
    and classes is a parameter or field of its counterpart in the port (the
    first ``NAME_MAP`` gives for a renamed one), unless ``PARAM_EXCLUDED``
    says why not."""
    params = _reference_parameters()
    assert len(params) > 300
    missing = []
    for key, names in params.items():
        if key in EXCLUDED:
            continue
        target = NAME_MAP.get(key, ("repro_torch" + key[len("repro"):],))[0]
        got = _port_parameters(target)
        missing += [f"{key}({p}) -> {target}" for p in names
                    if p not in got and p not in _excluded_parameters(key)]
    assert not missing, "\n".join(missing)


def test_every_parameter_exclusion_is_needed():
    """Each excluded parameter is the reference's and missing from the port's
    counterpart, and has its reason."""
    params = _reference_parameters()
    seen = set()
    for key, names in params.items():
        if key in EXCLUDED:
            continue
        target = NAME_MAP.get(key, ("repro_torch" + key[len("repro"):],))[0]
        seen |= {p for p in set(names) & set(PARAM_EXCLUDED["*"][0])
                 if p not in _port_parameters(target)}
    assert seen == set(PARAM_EXCLUDED["*"][0])
    for key, (names, why) in PARAM_EXCLUDED.items():
        assert why
        if key == "*":
            continue
        target = NAME_MAP.get(key, ("repro_torch" + key[len("repro"):],))[0]
        assert set(names) <= set(params[key]), key
        assert not set(names) & _port_parameters(target), key


# -- the parameters behind the names: backend=, mesh=, overwrite=, graph_default=, ep --

def test_store_backend_override_builds_the_references_banks():
    """``SketchStore(backend="serial")`` builds through the serial ring (its
    bucket merges run; the spec alone would pick the single path) banks
    byte-equal to the reference's store with the same override; the shadow
    keeps the backend; a ``Backend`` instance overrides as a name does."""
    from repro.core.difuser import DiFuserConfig as R_Config
    from repro.launch.common import make_graph as ref_graph
    from repro.runtime import RunSpec as R_RunSpec
    from repro.service import SketchStore as R_Store
    from repro_torch.core.difuser import DiFuserConfig
    from repro_torch.kernels import counters
    from repro_torch.launch.common import make_graph
    from repro_torch.runtime import RunSpec, get_backend
    from repro_torch.service import SketchStore

    cfg = DiFuserConfig(num_registers=64)
    want = R_Store(num_banks=2, backend="serial", spec=R_RunSpec(mu_v=2)).get_or_build(
        ref_graph("rmat:8", "0.1", 0), R_Config(num_registers=64, impl="ref"))
    for backend in ("serial", get_backend("serial")):
        store = SketchStore(num_banks=2, backend=backend, spec=RunSpec(mu_v=2), device="cpu")
        counters.reset()
        got = store.get_or_build(make_graph("rmat:8", "0.1", 0), cfg)
        assert counters.PLAIN_CALLS.get("bucket_propagate", 0) > 0
        assert "propagate_sweep" not in counters.PLAIN_CALLS
        assert len(got.banks) == 2
        for a, b in zip(got.banks, want.banks):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert store.shadow(got.key).backend is backend
    assert SketchStore(device="cpu").backend is None


def test_engines_take_backend_and_refuse_it_beside_a_store():
    from repro.service import InfluenceEngine as R_Engine
    from repro.service import SketchStore as R_Store
    from repro_torch.service import AsyncInfluenceEngine, InfluenceEngine, SketchStore

    with pytest.raises(ValueError, match="SketchStore itself"):
        R_Engine(R_Store(), backend="serial")
    store = SketchStore(device="cpu")
    for kw in ({"backend": "serial"}, {"spec": object()}, {"device": "cpu"}):
        with pytest.raises(ValueError, match="SketchStore itself"):
            InfluenceEngine(store, **kw)
    assert InfluenceEngine(backend="serial", device="cpu").store.backend == "serial"
    with AsyncInfluenceEngine(backend="serial", device="cpu") as aeng:
        assert aeng.store.backend == "serial"


def test_register_backend_overwrite_and_get_backend_passes_an_instance():
    from repro.runtime import base as R_base
    from repro_torch.runtime import base

    saved = dict(base._BACKENDS)
    try:
        for mod in (R_base, base):
            b = mod.get_backend("serial")
            assert mod.get_backend(b) is b
            clone = type(b)()
            with pytest.raises(ValueError, match="already registered"):
                mod.register_backend(clone)
            assert mod.get_backend("serial") is b
            if mod is base:   # the reference's registry is left as it is
                assert base.register_backend(clone, overwrite=True) is clone
                assert base.get_backend("serial") is clone
    finally:
        base._BACKENDS.clear()
        base._BACKENDS.update(saved)


def test_single_and_serial_backends_ignore_a_mesh():
    from repro_torch.core.sketch import VISITED
    from repro_torch.launch.common import make_graph
    from repro_torch.partition import plan_partition
    from repro_torch.runtime import RunSpec, get_backend

    g = make_graph("rmat:7", "0.1", 0)
    mesh = object()   # not a mesh at all: both ignore it, as the reference's do
    for name, spec in (("single", RunSpec(num_registers=32)),
                       ("serial", RunSpec(num_registers=32, mu_v=2))):
        b = get_backend(name)
        want = b.find_seeds(g, 2, spec, device="cpu").result
        got = b.find_seeds(g, 2, spec, mesh=mesh, device="cpu").result
        np.testing.assert_array_equal(got.seeds, want.seeds)
        m, _ = b.build_matrix(g, spec, want.x, device="cpu")
        m2, _ = b.build_matrix(g, spec, want.x, mesh=mesh, device="cpu")
        assert torch.equal(m, m2)
    # a repair from an all-VISITED matrix (inert: one sweep) with and without
    gs = g.sorted_by_dst()
    plan = plan_partition(gs, 2, device="cpu")
    planned = torch.full((plan.n_pad, 32), VISITED, dtype=torch.int8)
    serial, x = get_backend("serial"), np.sort(want.x)
    want = serial.repair_plan_shards(gs, spec, x, planned, plan, (0, 1))
    got = serial.repair_plan_shards(gs, spec, x, planned, plan, (0, 1), mesh=mesh)
    assert torch.equal(got[0], want[0]) and got[1:] == want[1:]


def test_common_im_args_graph_default_and_sampled_edges_ep():
    import argparse

    from repro.launch.common import add_common_im_args as ref_args
    from repro.launch.common import make_graph as ref_graph
    from repro.partition import plan as R_plan
    from repro_torch.launch.common import add_common_im_args, make_graph
    from repro_torch.partition import plan as T_plan

    for fn in (ref_args, add_common_im_args):
        args = fn(argparse.ArgumentParser(), graph_default="rmat:7").parse_args([])
        assert args.graph == "rmat:7"
    x = np.sort(np.random.default_rng(0).integers(0, 1 << 32, 64, dtype=np.uint64)
                .astype(np.uint32))
    want = R_plan.sample_edge_sets(ref_graph("rmat:8", "0.1", 0), x, 2, model="lt")
    got = T_plan.sample_edge_sets(make_graph("rmat:8", "0.1", 0), x, 2, model="lt",
                                  device="cpu")
    for f in ("h", "lo", "thr"):
        a, b = getattr(got.ep, f), getattr(want.ep, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert got.h.numpy().view(np.uint32).tobytes() == got.ep.h.tobytes()


# -- core/sketch.py ------------------------------------------------------------------

def _matrix(rng, n, j):
    m = rng.integers(0, 33, (n, j), dtype=np.int8)
    m[rng.random((n, j)) < 0.2] = -1
    m[3] = -1                                     # a row with no valid register
    return m


def test_hll_alpha_and_exact_distinct_reference():
    from repro.core import sketch as R
    from repro_torch.core import sketch as T

    for j in (16, 32, 48, 64, 100, 128, 1024):
        assert T.hll_alpha(j) == R.hll_alpha(j)
    items = np.random.default_rng(0).integers(0, 1 << 30, 500)
    for num_regs, seed in ((64, 0), (256, 7)):
        assert T.exact_distinct_reference(items, num_regs, seed) == \
            R.exact_distinct_reference(items, num_regs, seed)


@pytest.mark.parametrize("num_regs,reg_offset,seed", [(64, 0, 0), (37, 192, 5)])
def test_fill_registers_matches_reference(num_regs, reg_offset, seed):
    from repro.core import sketch as R
    from repro_torch.core import sketch as T

    n_pad = 96
    visited = np.random.default_rng(1).random((n_pad, num_regs)) < 0.1
    want = np.asarray(R.fill_registers(n_pad, num_regs, reg_offset=reg_offset, seed=seed,
                                       visited=visited))
    got = T.fill_registers(n_pad, num_regs, reg_offset=reg_offset, seed=seed,
                           visited=visited, device="cpu")
    assert got.dtype == torch.int8 and tuple(got.shape) == (n_pad, num_regs)
    np.testing.assert_array_equal(got.numpy(), want)
    # row ids: row r is vertex ids[r], as the reference's rows of those ids
    ids = np.random.default_rng(2).permutation(4 * n_pad)[:n_pad]
    whole = np.asarray(R.fill_registers(4 * n_pad, num_regs, reg_offset=reg_offset,
                                        seed=seed))
    for dtype in (np.int32, np.int64):
        got = T.fill_registers(n_pad, num_regs, reg_offset=reg_offset, seed=seed,
                               ids=ids.astype(dtype), device="cpu")
        np.testing.assert_array_equal(got.numpy(), whole[ids])


def test_sketch_fill_ids_equals_fill_registers_and_the_whole_fill():
    """``sketch_fill_plain(ids=...)`` equals ``fill_registers`` with the same
    ids and the whole matrix's fill with its rows selected (the mesh rank's
    fill before and after it took the row-id operand); VISITED stays."""
    from repro_torch.core.sketch import VISITED, blank_matrix, fill_registers
    from repro_torch.kernels import counters
    from repro_torch.kernels.sketch_fill import sketch_fill_plain

    n_pad, j, off = 200, 64, 128
    ids = torch.from_numpy(np.random.default_rng(3).permutation(n_pad)[:50])
    m = blank_matrix(50, j, "cpu")
    m[7, 5:9] = VISITED
    counters.reset()
    got = sketch_fill_plain(m, ids=ids, reg_offset=off, seed=9)
    assert dict(counters.PLAIN_CALLS) == {"sketch_fill": 1}
    whole = sketch_fill_plain(blank_matrix(n_pad, j, "cpu"), reg_offset=off, seed=9)
    want = whole.index_select(0, ids)
    want[7, 5:9] = VISITED
    assert torch.equal(got, want)
    visited = np.zeros((50, j), dtype=bool)
    visited[7, 5:9] = True
    assert torch.equal(fill_registers(50, j, reg_offset=off, seed=9, ids=ids.numpy(),
                                      visited=visited, device="cpu"), got)
    assert torch.equal(sketch_fill_plain(m, ids=ids.to(torch.int32), reg_offset=off, seed=9),
                       got)
    with pytest.raises(ValueError, match="ids must be"):
        sketch_fill_plain(m, ids=ids[:10])


def test_merge_estimators_and_partial_sums_match_reference():
    from repro.core import sketch as R
    from repro_torch.core import sketch as T

    rng = np.random.default_rng(4)
    a, b = _matrix(rng, 64, 48), _matrix(rng, 64, 48)
    np.testing.assert_array_equal(T.merge(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(R.merge(a, b)))
    for est in ("hll", "fm_mean"):
        got = T.estimate_cardinality(torch.from_numpy(a), estimator=est)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(R.estimate_cardinality(
            a, estimator=est)), rtol=1e-6, atol=0)
        sums = T.partial_sums(torch.from_numpy(a), estimator=est)
        assert sums.dtype == torch.float32 and tuple(sums.shape) == (2, 64)
        np.testing.assert_allclose(sums.numpy(), np.asarray(R.partial_sums(
            a, estimator=est)), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="unknown estimator"):
        T.partial_sums(torch.from_numpy(a), estimator="median")
    assert T.REG_DTYPE == torch.int8


# -- core/select.py, core/sampling.py ------------------------------------------------

def test_topk_candidates_matches_reference_and_keeps_ties_in_index_order():
    from repro.core import select as R
    from repro_torch.core import select as T

    rng = np.random.default_rng(5)
    stat = rng.random(40).astype(np.float32) * 50
    count = rng.integers(0, 65, 40).astype(np.float32)
    stat[[4, 9, 17, 30]] = stat[2]                 # ties, and their counts
    count[[4, 9, 17, 30]] = count[2] = 64
    sums = np.stack([stat, count])
    for est, c in (("hll", 8), ("fm_mean", 12)):
        ids, vals = T.topk_candidates(torch.from_numpy(sums), 64, 36, c, estimator=est)
        want_ids, want_vals = R.topk_candidates(sums, 64, 36, c, estimator=est)
        assert ids.dtype == torch.int32 and vals.dtype == torch.float32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
        np.testing.assert_allclose(vals.numpy(), np.asarray(want_vals), rtol=1e-6, atol=0)
    # five equal estimates come back in index order, the padding rows last
    flat = np.stack([np.ones(10, np.float32), np.full(10, 64, np.float32)])
    ids, _ = T.topk_candidates(torch.from_numpy(flat), 64, 5, 7)
    assert ids.tolist() == [0, 1, 2, 3, 4, 5, 6]
    assert np.asarray(R.topk_candidates(flat, 64, 5, 7)[0]).tolist() == ids.tolist()


def test_numpy_predicates_sample_mask_and_clz32_match_reference():
    from repro.core import sampling as R
    from repro_torch.core import sampling as T

    rng = np.random.default_rng(6)
    u32 = lambda *shape: rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    h, lo, thr, x = u32(50, 1), u32(50, 1), u32(50, 1), u32(1, 33)
    for name in ("fused_predicate", "remix_interval_predicate"):
        np.testing.assert_array_equal(getattr(T, name)(h, lo, thr, x),
                                      getattr(R, name)(h, lo, thr, x))
    np.testing.assert_array_equal(T.sample_mask(h[:, 0], thr[:, 0], x[0]),
                                  R.sample_mask(h[:, 0], thr[:, 0], x[0]))
    vals = np.concatenate([u32(1000), np.array([0, 1, 2, 0xFFFFFFFF], dtype=np.uint32)])
    got = T.clz32(vals)
    np.testing.assert_array_equal(got, R.clz32(vals))
    assert got.dtype == np.int32 and got[-4:].tolist() == [32, 31, 30, 0]


# -- diffusion/models.py -------------------------------------------------------------

@pytest.fixture
def registry():
    """The port's model registry, restored after the test."""
    from repro_torch.diffusion import models

    saved = dict(models._REGISTRY)
    yield models
    models._REGISTRY.clear()
    models._REGISTRY.update(saved)
    models._RESOLVED.clear()


def test_model_registry_and_edge_delay_match_reference(registry):
    from repro import diffusion as RD
    from repro.diffusion import models as RM
    from repro.launch.common import make_graph as ref_graph
    from repro_torch import diffusion as TD
    from repro_torch.launch.common import make_graph

    assert TD.available_models() == RD.available_models() == ("wc", "ic", "lt", "dic")
    assert TD.resolve("dic:0.5") is TD.resolve("dic:0.5")          # one instance a spec
    assert TD.resolve("dic:0.5") is not TD.resolve("dic")
    tg, rg = make_graph("rmat:7", "0.1", 0), ref_graph("rmat:7", "0.1", 0)
    np.testing.assert_array_equal(TD.resolve("dic").edge_delay(tg),
                                  RM.DecayingIC().edge_delay(rg))
    np.testing.assert_array_equal(TD.resolve("dic:2").live_edge_probability(tg),
                                  RD.resolve("dic:2").live_edge_probability(rg))
    with pytest.raises(ValueError, match="already registered"):
        TD.register_model("wc", lambda spec, param: None)


def test_registered_models_name_a_kernel_variant(registry):
    from repro_torch import diffusion as TD
    from repro_torch.core.sampling import REMIX, remix_interval_predicate
    from repro_torch.diffusion.models import WeightedCascade

    class RemixWC(WeightedCascade):
        name = "rwc"
        predicate = staticmethod(remix_interval_predicate)

    class Custom(WeightedCascade):
        name = "custom"
        predicate = staticmethod(lambda h, lo, thr, x: (h ^ x) < thr)

    TD.register_model("rwc", lambda spec, param: RemixWC(spec))
    TD.register_model("custom", lambda spec, param: Custom(spec))
    assert TD.available_models()[-2:] == ("rwc", "custom")
    assert TD.resolve("rwc").variant == REMIX
    with pytest.raises(ValueError, match="fused_predicate.*remix_interval_predicate"):
        TD.resolve("custom")


# -- graphs, partition, baselines, runtime -------------------------------------------

def test_npz_cache_round_trips_both_ways(tmp_path):
    from repro.graphs import io as RIO
    from repro.launch.common import make_graph as ref_graph
    from repro_torch.graphs import io as TIO
    from repro_torch.launch.common import make_graph

    g = make_graph("rmat:7", "0.1", 0)
    TIO.save_npz(str(tmp_path / "port.npz"), g)
    RIO.save_npz(str(tmp_path / "ref.npz"), ref_graph("rmat:7", "0.1", 0))
    for got in (TIO.load_npz(str(tmp_path / "port.npz")),
                TIO.load_npz(str(tmp_path / "ref.npz")),
                RIO.load_npz(str(tmp_path / "port.npz"))):
        assert (got.n, got.n_pad, got.m_real) == (g.n, g.n_pad, g.m_real)
        for f in ("src", "dst", "weight"):
            np.testing.assert_array_equal(getattr(got, f), getattr(g, f))
    built = []
    path = str(tmp_path / "sub" / "cached.npz")
    for _ in range(2):
        got = TIO.cached(path, lambda: built.append(1) or g)
        np.testing.assert_array_equal(got.src, g.src)
    assert built == [1]


def test_graph_and_csr_helpers_match_reference():
    from repro.launch.common import make_graph as ref_graph
    from repro_torch.launch.common import make_graph

    tg, rg = make_graph("rmat:7", "0.1", 0), ref_graph("rmat:7", "0.1", 0)
    w = np.random.default_rng(8).random(tg.m).astype(np.float32)
    for a, b in ((tg.with_weights(w), rg.with_weights(w)), (tg.reverse(), rg.reverse())):
        for f in ("src", "dst", "weight"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.n, a.n_pad, a.m_real) == (b.n, b.n_pad, b.m_real)
    tc, rc = tg.csr(), rg.csr()
    for u in range(tg.n):
        np.testing.assert_array_equal(tc.neighbors(u), rc.neighbors(u))
        np.testing.assert_array_equal(tc.neighbor_weights(u), rc.neighbor_weights(u))


def test_local_row_of_matches_reference():
    from repro.launch.common import make_graph as ref_graph
    from repro.partition import plan as RP
    from repro_torch.launch.common import make_graph
    from repro_torch.partition import plan as TP

    tg, rg = make_graph("rmat:8", "0.1", 0), ref_graph("rmat:8", "0.1", 0)
    ids = np.arange(tg.n)
    for strategy in ("block", "degree", "random"):
        got, want = (TP.plan_partition(tg, 4, strategy=strategy, device="cpu"),
                     RP.plan_partition(rg, 4, strategy=strategy))
        rows = got.local_row_of(ids)
        assert rows.dtype == np.int32
        np.testing.assert_array_equal(rows, want.local_row_of(ids))
        np.testing.assert_array_equal(got.owned_ids()[got.owner_of(ids), rows], ids)


@pytest.mark.parametrize("model", ["wc", "ic:0.2", "lt", "dic"])
def test_sample_live_mask_matches_reference(model):
    from repro.baselines import sample_live_mask as ref_mask
    from repro.launch.common import make_graph as ref_graph
    from repro_torch.baselines import sample_live_mask
    from repro_torch.launch.common import make_graph

    tg, rg = make_graph("rmat:7", "0.1", 0), ref_graph("rmat:7", "0.1", 0)
    got = sample_live_mask(tg, model, np.random.default_rng(11))
    assert got.dtype == bool and got.shape == (tg.m_real,)
    np.testing.assert_array_equal(got, ref_mask(rg, model, np.random.default_rng(11)))


def test_backend_available_is_an_environment_check():
    import torch.distributed as dist

    from repro.runtime import available_backends as ref_available
    from repro_torch import baselines, diffusion, runtime

    got = runtime.available_backends()
    assert list(got) == sorted(ref_available()) == ["mesh", "serial", "single"]
    assert got["single"] == got["serial"] == (True, "")
    assert got["mesh"] == (True, "") and dist.is_available()
    assert not dist.is_initialized()   # available without a group; supports says no
    ok, why = runtime.get_backend("mesh").supports(None, runtime.RunSpec(mu_v=2, mu_s=2))
    assert not ok and "process group" in why
    for pkg, names in ((runtime, ("available_backends",)),
                       (diffusion, ("register_model", "available_models")),
                       (baselines, ("sample_live_mask",))):
        assert set(names) <= set(pkg.__all__)
