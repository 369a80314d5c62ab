"""The kernels' plain versions against the reference's ``repro.kernels.ref``
(and, for fill, cardinality and fused sampling, their Pallas bodies in
interpret mode) or, for the ring's bucket merges, the reference's jnp merges
of ``repro.core.distributed``; and the CUDA kernels against their plain
versions on a CUDA device.

Inputs are made with numpy from a seed and handed to both packages. The
reference's propagate, cascade, fused-sweep and bucket Pallas bodies do not
run on this jax (``pl.load`` is gone), so those are held against
``repro.kernels.ref`` and the jnp merges.
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import two_torch_threads  # noqa: F401  (autouse)
from repro.core.distributed import _bucket_sweep_cascade, _bucket_sweep_propagate
from repro.core.sampling import fused_predicate, remix_interval_predicate
from repro.kernels import ref
from repro.kernels.fused_sample import fused_sample_pallas
from repro.kernels.sketch_cardinality import cardinality_stats_pallas
from repro.kernels.sketch_fill import sketch_fill_pallas
from repro_torch.kernels import (bucket_propagate, cascade_step, counters, fused_sample,
                                 fused_sweep, ops, sketch_cardinality, sketch_fill,
                                 sketch_propagate)
from repro_torch.kernels.edges import CHUNK, EdgeOperands, group_rows, with_work

REF_PRED = {0: fused_predicate, 1: remix_interval_predicate}

# (n_pad, J, E): a prime edge count, J off multiples of 32 and of 4
CASES = [(64, 128, 509), (72, 100, 251), (40, 37, 127), (136, 256, 1021)]


def _case(n_pad, num_regs, num_edges, seed):
    rng = np.random.default_rng(seed)
    m = rng.integers(-1, 33, size=(n_pad, num_regs)).astype(np.int8)
    m[rng.random(n_pad) < 0.15] = -1
    m[1] = -1
    src = rng.integers(0, n_pad, num_edges).astype(np.int32)
    dst = rng.integers(0, n_pad, num_edges).astype(np.int32)

    def u32(n):
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)

    h, lo = u32(num_edges), u32(num_edges)
    thr = u32(num_edges) >> rng.integers(0, 6, num_edges).astype(np.uint32)
    thr[rng.random(num_edges) < 0.1] = 0
    order = np.lexsort((src, dst))
    return m, (src[order], dst[order], h[order], lo[order], thr[order]), u32(num_regs)


#: rows of these many edges in a hub case: a star, and rows around CHUNK
HUB_DEGREES = (40_000, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 1)


def _hub_case(num_regs, seed, n_pad=520):
    """Like ``_case``, on a graph whose sweeps split rows: sources 10-14 and
    destinations 20-24 with ``HUB_DEGREES`` edges, their other ends and 1000
    random edges among rows 30-499, and rows 500 and up without edges."""
    rng = np.random.default_rng(seed)
    m = rng.integers(-1, 33, size=(n_pad, num_regs)).astype(np.int8)
    m[rng.random(n_pad) < 0.15] = -1
    src, dst = [rng.integers(30, 500, 1000)], [rng.integers(30, 500, 1000)]
    for i, deg in enumerate(HUB_DEGREES):
        src += [np.full(deg, 10 + i), rng.integers(30, 500, deg)]
        dst += [rng.integers(30, 500, deg), np.full(deg, 20 + i)]
    src, dst = np.concatenate(src).astype(np.int32), np.concatenate(dst).astype(np.int32)
    num_edges = src.shape[0]

    def u32(n):
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)

    h, lo = u32(num_edges), u32(num_edges)
    thr = u32(num_edges) >> rng.integers(0, 6, num_edges).astype(np.uint32)
    thr[rng.random(num_edges) < 0.1] = 0
    order = np.lexsort((src, dst))
    return m, (src[order], dst[order], h[order], lo[order], thr[order]), u32(num_regs)


def _port(m, edges, x, n_pad, device="cpu"):
    return (torch.from_numpy(m).to(device), EdgeOperands.from_numpy(*edges, n_pad, device),
            torch.from_numpy(x.view(np.int32)).to(device))


@pytest.mark.parametrize("reg_offset,seed", [(0, 0), (32, 4), (0xFFFFFFF0, 7)])
@pytest.mark.parametrize("n_pad,num_regs,num_edges", CASES)
def test_sketch_fill_plain(n_pad, num_regs, num_edges, reg_offset, seed):
    m, _, _ = _case(n_pad, num_regs, num_edges, seed=1)
    want = np.asarray(ref.sketch_fill_ref(jnp.asarray(m), reg_offset=reg_offset, seed=seed))
    got = sketch_fill.sketch_fill_plain(torch.from_numpy(m), reg_offset=reg_offset, seed=seed)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[m == -1] == -1).all()


@pytest.mark.parametrize("num_regs", [64, 128, 256])
def test_sketch_fill_plain_vs_pallas(num_regs):
    m = np.zeros((264, num_regs), np.int8)
    m[5] = -1
    want = np.asarray(sketch_fill_pallas(jnp.asarray(m), reg_offset=32, seed=4))
    got = sketch_fill.sketch_fill_plain(torch.from_numpy(m), reg_offset=32, seed=4)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_pad,num_regs,num_edges", CASES)
def test_cardinality_plain(n_pad, num_regs, num_edges):
    m, _, _ = _case(n_pad, num_regs, num_edges, seed=2)
    stat, count = (np.asarray(a) for a in ref.cardinality_stats_ref(jnp.asarray(m)))
    got = sketch_cardinality.cardinality_stats_plain(torch.from_numpy(m)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, n_pad)
    np.testing.assert_allclose(got[0], stat, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[1], count)


@pytest.mark.parametrize("n_pad,num_regs", [(64, 64), (264, 128), (512, 1024)])
def test_cardinality_plain_vs_pallas(n_pad, num_regs):
    m = np.array(ref.sketch_fill_ref(jnp.zeros((n_pad, num_regs), jnp.int8)))
    m[0, : num_regs // 2] = -1
    stat, count = (np.asarray(a) for a in cardinality_stats_pallas(jnp.asarray(m)))
    got = sketch_cardinality.cardinality_stats_plain(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got[0], stat, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[1], count)


def _ref_sweep(fn, m, edges, x, variant):
    src, dst, h, lo, thr = (jnp.asarray(a) for a in edges)
    return np.asarray(fn(jnp.asarray(m), src, dst, thr, jnp.asarray(x), h, lo,
                         predicate=REF_PRED[variant]))


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("n_pad,num_regs,num_edges", CASES)
def test_propagate_plain(n_pad, num_regs, num_edges, variant):
    m, edges, x = _case(n_pad, num_regs, num_edges, seed=3)
    want = _ref_sweep(ref.propagate_sweep_ref, m, edges, x, variant)
    got, changed = sketch_propagate.propagate_sweep_plain(*_port(m, edges, x, n_pad),
                                                          variant=variant)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(changed.item()) == bool((want != m).any())
    assert (got.numpy()[m == -1] == -1).all()


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("n_pad,num_regs,num_edges", CASES)
def test_cascade_plain(n_pad, num_regs, num_edges, variant):
    m, edges, x = _case(n_pad, num_regs, num_edges, seed=4)
    want = _ref_sweep(ref.cascade_sweep_ref, m, edges, x, variant)
    got, changed = cascade_step.cascade_sweep_plain(*_port(m, edges, x, n_pad),
                                                    variant=variant)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(changed.item()) == bool((want != m).any())


# ------------------------------------------- the serial ring's kernels ----

# (n_loc, j_loc, slots): a prime slot count, an empty bucket, j_loc off
# multiples of 32 and of 4
BUCKETS = [(64, 128, 509), (72, 100, 251), (40, 36, 0), (136, 256, 1021), (33, 37, 97)]


def _bucket(n_loc, j_loc, slots, seed):
    """acc and block (VISITED rows in both), a bucket's slots (w, r, h, lo,
    thr) as numpy, and x."""
    rng = np.random.default_rng(seed)

    def matrix():
        m = rng.integers(-1, 33, size=(n_loc, j_loc)).astype(np.int8)
        m[rng.random(n_loc) < 0.15] = -1
        return m

    def u32(n):
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)

    acc, block = matrix(), matrix()
    acc[2] = -1
    w = rng.integers(0, n_loc, slots).astype(np.int32)
    r = rng.integers(0, n_loc, slots).astype(np.int32)
    thr = u32(slots) >> rng.integers(0, 6, slots).astype(np.uint32)
    thr[rng.random(slots) < 0.1] = 0
    return acc, block, (w, r, u32(slots), u32(slots), thr), u32(j_loc)


def _rows(slots, n_loc, device="cpu"):
    w, r, h, lo, thr = (torch.from_numpy(a.view(np.int32)).to(device) for a in slots)
    return with_work(group_rows(w, r, h, lo, thr, n_loc))


#: write rows of these many slots in a hub bucket: the longest row of phase
#: 4b's buckets at rmat:20, rows just over and at CHUNK, and an empty row
BUCKET_HUB_DEGREES = (13_657, CHUNK + 1, CHUNK, 0)


def _hub_bucket(j_loc, seed, n_loc=600):
    """Like ``_bucket``, on a bucket whose work list splits rows: write rows
    10-13 with ``BUCKET_HUB_DEGREES`` slots, 1000 random slots among write
    rows 30-559, rows 560 and up without slots; read rows anywhere."""
    acc, block, _, x = _bucket(n_loc, j_loc, 0, seed)
    rng = np.random.default_rng(seed + 1)
    w = np.concatenate([rng.integers(30, n_loc - 40, 1000)]
                       + [np.full(d, 10 + i) for i, d in enumerate(BUCKET_HUB_DEGREES)])
    slots = w.shape[0]

    def u32(n):
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)

    r = rng.integers(0, n_loc, slots).astype(np.int32)
    thr = u32(slots) >> rng.integers(0, 6, slots).astype(np.uint32)
    thr[rng.random(slots) < 0.1] = 0
    return acc, block, (w.astype(np.int32), r, u32(slots), u32(slots), thr), x


def _xt(x, device="cpu"):
    return torch.from_numpy(x.view(np.int32)).to(device)


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("n_loc,j_loc,slots", BUCKETS)
def test_bucket_propagate_plain(n_loc, j_loc, slots, variant):
    acc, block, sl, x = _bucket(n_loc, j_loc, slots, seed=8)
    w, r, h, lo, thr = (jnp.asarray(a) for a in sl)
    want = _bucket_sweep_propagate(jnp.asarray(acc), jnp.asarray(block), h, w, r, thr,
                                   jnp.asarray(x), lo, REF_PRED[variant])
    want = np.asarray(jnp.where(jnp.asarray(acc) == -1, jnp.asarray(acc), want))
    got = torch.from_numpy(acc.copy())
    changed = bucket_propagate.bucket_propagate_plain(
        got, torch.from_numpy(block), _rows(sl, n_loc), _xt(x), variant=variant)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(changed.item()) == bool((want != acc).any())
    assert (got.numpy()[acc == -1] == -1).all()


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("n_loc,j_loc,slots", BUCKETS)
def test_bucket_cascade_plain(n_loc, j_loc, slots, variant):
    acc, block, sl, x = _bucket(n_loc, j_loc, slots, seed=9)
    w, r, h, lo, thr = (jnp.asarray(a) for a in sl)
    vis = _bucket_sweep_cascade((jnp.asarray(acc) == -1).astype(jnp.uint8),
                                jnp.asarray(block), h, w, r, thr, jnp.asarray(x), lo,
                                REF_PRED[variant])
    want = np.where(np.asarray(vis).astype(bool), np.int8(-1), acc)
    got = torch.from_numpy(acc.copy())
    changed = bucket_propagate.bucket_cascade_plain(
        got, torch.from_numpy(block), _rows(sl, n_loc), _xt(x), variant=variant)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(changed.item()) == bool((want != acc).any())


@pytest.mark.parametrize("merge", ["bucket_propagate_plain", "bucket_cascade_plain"])
def test_bucket_merge_refuses_shared_memory(merge):
    acc, _, sl, x = _bucket(16, 32, 40, seed=1)
    t = torch.from_numpy(acc)
    with pytest.raises(ValueError, match="must not share memory"):
        getattr(bucket_propagate, merge)(t, t, _rows(sl, 16), _xt(x), variant=0)


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("num_sweeps,lane_fill", [(0, 0), (1, 0), (2, 8), (3, 24), (2, 256)])
@pytest.mark.parametrize("n_loc,j_loc,slots", BUCKETS[:4])
def test_fused_sweep_plain(n_loc, j_loc, slots, num_sweeps, lane_fill, variant):
    m, _, sl, x = _bucket(n_loc, j_loc, slots, seed=10)
    w, r, h, lo, thr = (jnp.asarray(a) for a in sl)
    want = np.asarray(ref.fused_sweep_ref(jnp.asarray(m), w, r, thr, jnp.asarray(x), h, lo,
                                          num_sweeps=num_sweeps, lane_fill=lane_fill,
                                          predicate=REF_PRED[variant]))
    mt = torch.from_numpy(m.copy())
    got = fused_sweep.fused_sweep_plain(mt, _rows(sl, n_loc), _xt(x), variant=variant,
                                        num_sweeps=num_sweeps, lane_fill=lane_fill)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(mt.numpy(), m)   # the input is left as it was


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("num_edges,num_samples", [(509, 128), (251, 100), (0, 64), (97, 36)])
def test_fused_sample_plain(num_edges, num_samples, variant):
    _, _, (_, _, h, lo, thr), _ = _bucket(8, 4, num_edges, seed=11)
    x = _bucket(8, num_samples, 0, seed=12)[3]
    zeros = jnp.zeros(num_edges, jnp.int32)
    args = (zeros, zeros, jnp.asarray(thr), jnp.asarray(x), jnp.asarray(h), jnp.asarray(lo))
    want = np.asarray(ref.fused_sample_ref(*args, predicate=REF_PRED[variant]))
    got = fused_sample.fused_sample_plain(_xt(h), _xt(lo), _xt(thr), _xt(x), variant=variant)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (num_edges, num_samples)
    np.testing.assert_array_equal(got.numpy(), want)
    if num_edges:
        pal = fused_sample_pallas(*args, predicate=REF_PRED[variant], interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


def test_cpu_dispatch_takes_plain_versions():
    m, edges, x = _case(64, 128, 509, seed=5)
    mt, et, xt = _port(m, edges, x, 64)
    acc, block, sl, xb = _bucket(64, 128, 300, seed=6)
    rows = _rows(sl, 64)
    counters.reset()
    ops.sketch_fill(mt)
    ops.cardinality_stats(mt)
    ops.propagate_sweep(mt, et, xt, variant=0)
    ops.cascade_sweep(mt, et, xt, variant=1)
    ops.fused_sample(rows.h, rows.lo, rows.thr, _xt(xb), variant=0)
    ops.fused_sweep(torch.from_numpy(acc), rows, _xt(xb), variant=1, num_sweeps=2)
    ops.bucket_propagate(torch.from_numpy(acc), torch.from_numpy(block), rows, _xt(xb),
                         variant=0)
    ops.bucket_cascade(torch.from_numpy(acc), torch.from_numpy(block), rows, _xt(xb),
                       variant=0)
    assert not counters.LAUNCHES
    assert dict(counters.PLAIN_CALLS) == {
        "sketch_fill": 1, "sketch_cardinality": 1, "sketch_propagate": 1,
        "cascade_step": 1, "fused_sample": 1, "fused_sweep": 1, "bucket_propagate": 1,
        "bucket_cascade": 1}


def test_edge_rows_group_each_row():
    _, edges, _ = _case(72, 100, 251, seed=6)
    e = EdgeOperands.from_numpy(*edges, 72, "cpu")
    for rows, key, other in ((e.by_src, e.src, e.dst), (e.by_dst, e.dst, e.src)):
        ptr = rows.rowptr.numpy()
        assert ptr[0] == 0 and ptr[-1] == 251 and (np.diff(ptr) >= 0).all()
        for r in range(72):
            sel = (key == r).numpy()
            got = sorted(zip(rows.nbr[ptr[r]:ptr[r + 1]].tolist(),
                             rows.h[ptr[r]:ptr[r + 1]].tolist()))
            assert got == sorted(zip(other[sel].tolist(), e.h[sel].tolist()))


# ------------------------------------------------- the sweeps' work list ----

def _u32(t):
    return t.numpy().view(np.uint32)


def _check_work_list(rows, n_rows, num_edges):
    """The work list of ``rows``: items cover the edges in order, each
    within one row and at most ``CHUNK`` long, every row (an empty one too)
    at least once; split rows own consecutive partial slots. Returns each
    row's item count and degree."""
    w = rows.work
    rowptr, ptr = rows.rowptr.numpy(), w.item_ptr.numpy()
    item_row, slot = w.item_row.numpy(), w.item_slot.numpy()
    deg, size = np.diff(rowptr), np.diff(ptr)
    # every edge in exactly one item: the items cover the edges in order
    assert ptr[0] == 0 and ptr[-1] == num_edges and (size >= 0).all()
    assert size.max() <= CHUNK
    # each item within one row, the rows in order, every row at least once
    assert (np.diff(item_row) >= 0).all()
    assert (rowptr[item_row] <= ptr[:-1]).all() and (ptr[1:] <= rowptr[item_row + 1]).all()
    pieces = np.bincount(item_row, minlength=n_rows)
    np.testing.assert_array_equal(pieces, np.maximum(1, -(-deg // CHUNK)))
    # an unsplit row writes itself; a split row's items own distinct slots,
    # the consecutive range split_ptr gives the row
    split = np.flatnonzero(deg > CHUNK)
    np.testing.assert_array_equal(w.split_row.numpy(), split)
    assert (slot[np.isin(item_row, split, invert=True)] == -1).all()
    sp = w.split_ptr.numpy()
    assert w.num_partials == sp[-1] == (slot >= 0).sum()
    for k, r in enumerate(split):
        np.testing.assert_array_equal(slot[item_row == r], np.arange(sp[k], sp[k + 1]))
    return pieces, deg


@pytest.mark.parametrize("order", ["by_src", "by_dst"])
def test_work_list_cuts_rows_into_items(order):
    _, edges, _ = _hub_case(32, seed=20)
    e = EdgeOperands.from_numpy(*edges, 520, "cpu")
    pieces, deg = _check_work_list(getattr(e, order), 520, e.num_edges)
    hubs = (10, 11, 12, 13, 14) if order == "by_src" else (20, 21, 22, 23, 24)
    assert [int(deg[r]) for r in hubs] == list(HUB_DEGREES)
    assert [int(pieces[r]) for r in hubs] == [157, 1, 1, 2, 4]
    assert (deg[500:] == 0).all() and (pieces[500:] == 1).all()


def test_bucket_work_list_cuts_rows_into_items():
    _, _, sl, _ = _hub_bucket(32, seed=22)
    rows = _rows(sl, 600)
    pieces, deg = _check_work_list(rows, 600, sl[0].shape[0])
    assert [int(deg[r]) for r in (10, 11, 12, 13)] == list(BUCKET_HUB_DEGREES)
    assert [int(pieces[r]) for r in (10, 11, 12, 13)] == [54, 2, 1, 1]
    np.testing.assert_array_equal(rows.work.split_row.numpy(), [10, 11])
    assert rows.work.num_partials == 56
    # the empty rows are items of their own, without edges
    empty = np.flatnonzero(deg == 0)
    assert 13 in empty and (deg[560:] == 0).all()
    sizes = np.diff(rows.work.item_ptr.numpy())
    assert (sizes[np.isin(rows.work.item_row.numpy(), empty)] == 0).all()


def _emulate_work(own, gather, rows, x, variant, cascade, in_place=False, seed=None):
    """A work-item sweep as the kernels compute it (``csrc/items.cuh``): each
    item's result from its own row of ``own`` and its edges' rows of
    ``gather``, written to its row or to its partial slot, then each split
    row's partials folded into its row by max (propagate) or OR (cascade).
    ``in_place``: the items read and write one matrix, as the bucket cascade
    does with ``acc``, an item without edges is skipped, and the items run
    in a random order (``seed``). Returns ``(out, changed)``."""
    w = rows.work
    live = np.asarray(REF_PRED[variant](jnp.asarray(_u32(rows.h))[:, None],
                                        jnp.asarray(_u32(rows.lo))[:, None],
                                        jnp.asarray(_u32(rows.thr))[:, None],
                                        jnp.asarray(x)[None, :]))
    nbr, ptr = rows.nbr.numpy(), w.item_ptr.numpy()
    out = own.copy()
    src = out if in_place else own    # where an item reads its own row
    partial = np.zeros((w.num_partials, own.shape[1]), np.int8)

    def finish(acc, prev):
        if cascade:
            return np.where(acc, np.int8(-1), prev)
        return np.where(prev == -1, np.int8(-1), acc)

    items = list(zip(range(w.num_items), w.item_row.numpy(), w.item_slot.numpy()))
    if in_place:
        np.random.default_rng(seed).shuffle(items)
    for i, r, slot in items:
        a, b = ptr[i], ptr[i + 1]
        if in_place and a == b:
            continue
        if cascade:
            acc = (src[r] == -1) | (live[a:b] & (gather[nbr[a:b]] == -1)).any(0)
        else:
            reads = np.where(live[a:b], gather[nbr[a:b]], -1).max(0, initial=-1)
            acc = np.maximum(src[r], reads)
        if slot >= 0:
            partial[slot] = acc
        else:
            out[r] = finish(acc, src[r])
    sp = w.split_ptr.numpy()
    for k, r in enumerate(w.split_row.numpy()):
        parts = partial[sp[k]:sp[k + 1]]
        prev = src[r].copy()
        acc = ((prev == -1) | parts.astype(bool).any(0)) if cascade else np.maximum(
            prev, parts.max(0))
        out[r] = finish(acc, prev)
    return out, bool((out != own).any())


def _emulate_items(m, e: EdgeOperands, x, variant, cascade):
    """The single path's sweep through ``_emulate_work`` (self_in = gather
    = m, a fresh output)."""
    return _emulate_work(m, m, e.by_dst if cascade else e.by_src, x, variant, cascade)[0]


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("sweep", ["propagate", "cascade"])
def test_work_items_merge_to_the_sweep(sweep, variant):
    m, edges, x = _hub_case(64, seed=21)
    cascade = sweep == "cascade"
    mt, et, xt = _port(m, edges, x, 520)
    got = _emulate_items(m, et, x, variant, cascade)
    ref_fn = ref.cascade_sweep_ref if cascade else ref.propagate_sweep_ref
    np.testing.assert_array_equal(got, _ref_sweep(ref_fn, m, edges, x, variant))
    plain = (cascade_step.cascade_sweep_plain if cascade
             else sketch_propagate.propagate_sweep_plain)
    want, changed = plain(mt, et, xt, variant=variant)
    np.testing.assert_array_equal(got, want.numpy())
    assert bool(changed.item()) == bool((got != m).any())
    assert (got[m == -1] == -1).all()


# a hub bucket (``_hub_bucket``, slots None): the work list splits rows
HUB_BUCKETS = [(600, 64, None), (600, 36, None)]


def _bucket_or_hub(n_loc, j_loc, slots, seed):
    return _hub_bucket(j_loc, seed, n_loc) if slots is None else _bucket(n_loc, j_loc, slots,
                                                                         seed)


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("n_loc,j_loc,slots", BUCKETS + HUB_BUCKETS)
def test_bucket_cascade_items_merge_in_place(n_loc, j_loc, slots, variant):
    acc, block, sl, x = _bucket_or_hub(n_loc, j_loc, slots, seed=23)
    acc[10, ::3] = -1              # a hub row partly VISITED, in acc and block
    block[sl[1][:50]] = -1
    rows = _rows(sl, n_loc)
    got, changed = _emulate_work(acc, block, rows, x, variant, cascade=True, in_place=True,
                                 seed=variant)
    w, r, h, lo, thr = (jnp.asarray(a) for a in sl)
    vis = _bucket_sweep_cascade((jnp.asarray(acc) == -1).astype(jnp.uint8),
                                jnp.asarray(block), h, w, r, thr, jnp.asarray(x), lo,
                                REF_PRED[variant])
    want = np.where(np.asarray(vis).astype(bool), np.int8(-1), acc)
    np.testing.assert_array_equal(got, want)
    plain = torch.from_numpy(acc.copy())
    flag = bucket_propagate.bucket_cascade_plain(plain, torch.from_numpy(block), rows, _xt(x),
                                                 variant=variant)
    np.testing.assert_array_equal(got, plain.numpy())
    assert changed == bool(flag.item())


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("n_loc,j_loc,slots", BUCKETS + HUB_BUCKETS)
def test_bucket_propagate_items_merge_in_place(n_loc, j_loc, slots, variant):
    """The propagate merge as the in-place item walk computes it (items in a
    random order on one matrix, split rows through partials, VISITED
    sticky) against the reference's merge and the plain version."""
    acc, block, sl, x = _bucket_or_hub(n_loc, j_loc, slots, seed=25)
    acc[10, ::3] = -1              # a hub row partly VISITED
    block[sl[1][:50]] = -1
    rows = _rows(sl, n_loc)
    got, changed = _emulate_work(acc, block, rows, x, variant, cascade=False, in_place=True,
                                 seed=variant)
    w, r, h, lo, thr = (jnp.asarray(a) for a in sl)
    want = _bucket_sweep_propagate(jnp.asarray(acc), jnp.asarray(block), h, w, r, thr,
                                   jnp.asarray(x), lo, REF_PRED[variant])
    want = np.asarray(jnp.where(jnp.asarray(acc) == -1, jnp.asarray(acc), want))
    np.testing.assert_array_equal(got, want)
    assert (got[acc == -1] == -1).all()
    plain = torch.from_numpy(acc.copy())
    flag = bucket_propagate.bucket_propagate_plain(plain, torch.from_numpy(block), rows,
                                                   _xt(x), variant=variant)
    np.testing.assert_array_equal(got, plain.numpy())
    assert changed == bool(flag.item())


@pytest.mark.parametrize("variant", [0, 1])
@pytest.mark.parametrize("num_sweeps", [1, 2, 3])
@pytest.mark.parametrize("n_loc,j_loc,slots", BUCKETS[:4] + HUB_BUCKETS)
def test_fused_sweep_items_equal_plain(n_loc, j_loc, slots, num_sweeps, variant):
    m, _, sl, x = _bucket_or_hub(n_loc, j_loc, slots, seed=24)
    rows = _rows(sl, n_loc)
    got = m
    for _ in range(num_sweeps):    # ping-pong: each sweep reads the last one's output
        got, _ = _emulate_work(got, got, rows, x, variant, cascade=False)
    w, r, h, lo, thr = (jnp.asarray(a) for a in sl)
    want = np.asarray(ref.fused_sweep_ref(jnp.asarray(m), w, r, thr, jnp.asarray(x), h, lo,
                                          num_sweeps=num_sweeps, predicate=REF_PRED[variant]))
    np.testing.assert_array_equal(got, want)
    plain = fused_sweep.fused_sweep_plain(torch.from_numpy(m), rows, _xt(x), variant=variant,
                                          num_sweeps=num_sweeps)
    np.testing.assert_array_equal(got, plain.numpy())


# ------------------------------------------------ on a CUDA device only ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    from repro_torch.kernels import build

    try:
        build.nvcc()
    except RuntimeError:
        pytest.skip(f"needs nvcc to build the kernels: none under $CUDA_HOME or on "
                    f"PATH ({shutil.which('nvcc')})")
    return torch.device("cuda")


# hub cases (``_hub_case``, num_edges None): the sweeps split rows
HUB_CASES = [(520, 256, None), (520, 1024, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_sketch_fill_ids_match_plain_on_cuda(cuda_device, id_dtype):
    """The row-id operand: row r hashes vertex ids[r] (a mesh rank's owned
    rows), VISITED kept, on the card as in the plain version."""
    from repro_torch.core.sketch import fill_registers

    m = torch.from_numpy(np.random.default_rng(8).integers(-1, 33, (300, 128),
                                                           dtype=np.int8))
    ids = torch.from_numpy(np.random.default_rng(9).permutation(1 << 20)[:300]).to(id_dtype)
    want = sketch_fill.sketch_fill_plain(m, ids=ids, reg_offset=256, seed=3)
    got = sketch_fill.sketch_fill_cuda(m.to(cuda_device), ids=ids.to(cuda_device),
                                       reg_offset=256, seed=3)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(fill_registers(300, 128, reg_offset=256, seed=3, ids=ids).cpu(),
                       sketch_fill.sketch_fill_plain(torch.zeros_like(m), ids=ids,
                                                     reg_offset=256, seed=3))


@pytest.mark.cuda
@pytest.mark.parametrize("n_pad,num_regs,num_edges", CASES + HUB_CASES)
def test_kernels_match_plain_on_cuda(cuda_device, n_pad, num_regs, num_edges):
    if num_edges is None:
        m, edges, x = _hub_case(num_regs, seed=7, n_pad=n_pad)
    else:
        m, edges, x = _case(n_pad, num_regs, num_edges, seed=7)
    mt, et, xt = _port(m, edges, x, n_pad, cuda_device)
    if num_regs % 4:  # the kernels move whole 32-bit words of registers
        for call in (lambda: sketch_fill.sketch_fill_cuda(mt),
                     lambda: sketch_cardinality.cardinality_stats_cuda(mt),
                     lambda: sketch_propagate.propagate_sweep_cuda(mt, et, xt, variant=0),
                     lambda: cascade_step.cascade_sweep_cuda(mt, et, xt, variant=0)):
            with pytest.raises(ValueError, match="multiple of 4"):
                call()
        return
    assert torch.equal(sketch_fill.sketch_fill_cuda(mt, reg_offset=5, seed=3),
                       sketch_fill.sketch_fill_plain(mt, reg_offset=5, seed=3))
    assert torch.equal(sketch_cardinality.cardinality_stats_cuda(mt),
                       sketch_cardinality.cardinality_stats_plain(mt))
    for variant in (0, 1):
        for mod, name in ((sketch_propagate, "propagate_sweep"),
                          (cascade_step, "cascade_sweep")):
            a, fa = getattr(mod, name + "_cuda")(mt, et, xt, variant=variant)
            b, fb = getattr(mod, name + "_plain")(mt, et, xt, variant=variant)
            assert torch.equal(a, b), (name, variant)
            assert bool(fa.item()) == bool(fb.item())


@pytest.mark.cuda
@pytest.mark.parametrize("n_loc,j_loc,slots", BUCKETS + [(600, 512, None), (600, 100, None)])
def test_ring_kernels_match_plain_on_cuda(cuda_device, n_loc, j_loc, slots):
    acc, block, sl, x = _bucket_or_hub(n_loc, j_loc, slots, seed=13)
    acc_t, block_t = torch.from_numpy(acc).to(cuda_device), torch.from_numpy(block).to(cuda_device)
    rows, xt = _rows(sl, n_loc, cuda_device), _xt(x, cuda_device)
    if j_loc % 4:  # the kernels move whole 32-bit words of registers
        with pytest.raises(ValueError, match="multiple of 4"):
            bucket_propagate.bucket_propagate_cuda(acc_t, block_t, rows, xt, variant=0)
        return
    for variant in (0, 1):
        for name in ("bucket_propagate", "bucket_cascade"):
            a, b = acc_t.clone(), acc_t.clone()
            fa = getattr(bucket_propagate, name + "_cuda")(a, block_t, rows, xt, variant=variant)
            fb = getattr(bucket_propagate, name + "_plain")(b, block_t, rows, xt, variant=variant)
            assert torch.equal(a, b), (name, variant)
            assert bool(fa.item()) == bool(fb.item())
        # both merges with a scratch passed in, larger than the list needs
        partial = torch.empty((rows.work.num_partials + 3, j_loc), dtype=torch.int8,
                              device=cuda_device)
        for name in ("bucket_propagate", "bucket_cascade"):
            a, b = acc_t.clone(), acc_t.clone()
            fa = getattr(bucket_propagate, name + "_cuda")(a, block_t, rows, xt,
                                                           variant=variant, partial=partial)
            fb = getattr(bucket_propagate, name + "_plain")(b, block_t, rows, xt,
                                                            variant=variant)
            assert torch.equal(a, b) and bool(fa.item()) == bool(fb.item()), name
        for num_sweeps in (1, 2, 3):
            assert torch.equal(
                fused_sweep.fused_sweep_cuda(acc_t, rows, xt, variant=variant,
                                             num_sweeps=num_sweeps),
                fused_sweep.fused_sweep_plain(acc_t, rows, xt, variant=variant,
                                              num_sweeps=num_sweeps))
        assert torch.equal(
            fused_sample.fused_sample_cuda(rows.h, rows.lo, rows.thr, xt, variant=variant),
            fused_sample.fused_sample_plain(rows.h, rows.lo, rows.thr, xt, variant=variant))


@pytest.mark.cuda
@pytest.mark.parametrize("num_samples", [36, 100, 128, 512])
def test_fused_sample_matches_plain_on_cuda(cuda_device, num_samples):
    """The 4-byte (36, 100) and 16-byte (128, 512) paths on a prime edge count."""
    _, _, (_, _, h, lo, thr), _ = _bucket(8, 4, 4099, seed=14)
    x = _bucket(8, num_samples, 0, seed=15)[3]
    args = [_xt(a, cuda_device) for a in (h, lo, thr, x)]
    for variant in (0, 1):
        assert torch.equal(fused_sample.fused_sample_cuda(*args, variant=variant),
                           fused_sample.fused_sample_plain(*args, variant=variant))
