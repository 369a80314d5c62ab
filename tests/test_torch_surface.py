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
import importlib
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
