"""The seed rounds' two fixpoints as timed spans, on the CPU: each round's
cascade and lazy rebuild are measured with the recorder off too, summed per
job into ``stats["cascade_s"]`` and ``stats["rebuild_s"]``, carry their
sweep counts, and leave every result as it was. On the single path and the
serial ring, at w = 0.01 on a graph of 512 vertices: at this size the live
graph is thin enough that the cascades run several sweeps a round and most
rounds rebuild, so both spans are exercised (on Graph500 SCALE 20 the hubs
carry the live graph, and its cascades are shallower than at w = 0.1)."""
import numpy as np
import pytest

from _torch_threads import two_torch_threads  # noqa: F401  (autouse)
from repro_torch.core import difuser
from repro_torch.graphs import rmat_graph
from repro_torch.obs import trace
from repro_torch.partition import serial

K = 6
PATHS = ("single", "serial")


def _run(path: str, seed: int = 3):
    g = rmat_graph(9, seed=5, setting="w01")
    cfg = difuser.DiFuserConfig(num_registers=64, seed=seed, model="wc")
    if path == "single":
        return difuser.find_seeds(g, K, cfg, device="cpu")
    res, _ = serial.find_seeds_ring_serial(g, K, cfg, strategy="degree", device="cpu")
    return res


def _recorded(path: str, seed: int = 3):
    rec = trace.get_recorder()
    rec.start()
    try:
        res = _run(path, seed)
        events = rec.events()
    finally:
        rec.stop()
        rec.clear()
    return res, events


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("path", PATHS)
def test_the_rounds_time_their_cascades_and_rebuilds(path, seed):
    st = _run(path, seed).stats
    assert st["cascade_s"] >= 0.0 and st["rebuild_s"] >= 0.0
    assert st["cascade_s"] + st["rebuild_s"] + st["visited_s"] <= st["rounds_s"]


@pytest.mark.parametrize("path", PATHS)
def test_the_spans_carry_the_sweeps_and_the_seconds(path):
    res, events = _recorded(path)
    cascades = [ev for ev in events if ev["name"] == f"{path}.cascade_fixpoint"]
    rebuilds = [ev for ev in events if ev["name"] == f"{path}.rebuild"]
    assert len(cascades) == K and len(rebuilds) == int(res.rebuilds.sum()) >= 1
    assert sum(ev["attrs"]["sweeps"] for ev in cascades) == res.stats["cascade_sweeps"]
    assert sum(ev["attrs"]["sweeps"] for ev in rebuilds) == res.stats["rebuild_sweeps"]
    assert all(ev["attrs"]["fill"] == 1 for ev in rebuilds)
    by_round = sorted(cascades, key=lambda ev: ev["attrs"]["round"])
    assert [ev["attrs"]["seed"] for ev in by_round] == res.seeds.tolist()
    assert sum(ev["dur_s"] for ev in cascades) == pytest.approx(res.stats["cascade_s"])
    assert sum(ev["dur_s"] for ev in rebuilds) == pytest.approx(res.stats["rebuild_s"])


@pytest.mark.parametrize("path", PATHS)
def test_results_are_the_same_with_the_recorder_on_and_off(path):
    off = _run(path)
    on, _ = _recorded(path)
    for name in ("seeds", "est_gains", "scores", "rebuilds"):
        a, b = getattr(off, name), getattr(on, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert off.propagate_iters == on.propagate_iters
    for key in ("cascade_sweeps", "rebuild_sweeps"):
        assert off.stats[key] == on.stats[key], key
    # at this size both spans are exercised: several cascade sweeps a round,
    # most rounds rebuilding
    assert off.stats["cascade_sweeps"] > 2 * K and np.count_nonzero(off.rebuilds) >= K // 2
