"""The comparison that decides ``correct`` fails what it must, in a whole
run of each cell at CPU size with the timed path broken underneath (the
harness's look for a card skipped):

* the control: the reference itself in the program's place, its score and
  estimate arithmetic one precision lower (bfloat16 for float32);
* a sweep that returns its state unchanged;
* half of the batch (the registers, one per simulation) left out of the
  selection's statistics, the mean taken over the rest;
* the exchange between shards left out (the ring's cross-shard buckets);
* an answer altered where it is produced (one round's seed).
"""
import types

import pytest
import torch

from imbench.reference import alg4
from imbench.tests._tiny import result, run_tiny, tiny_cell

SINGLE = ["g500-s20-ic01.k50", "g500-s19-lt.k10"]
GRID = "g500-s20-ic01.k50-grid2x2"


def _control_run(g, k, spec, device=None, **_):
    r = g.m_real
    ans = alg4.find_seeds(g.n, g.src[:r], g.dst[:r], g.weight[:r], model=spec.model,
                          num_registers=spec.num_registers, k=k, seed=spec.seed,
                          device=device, dtype=torch.bfloat16, sim_shards=spec.mu_s)
    stats = dict(cascade_sweeps=ans.cascade_sweeps, rebuild_sweeps=ans.rebuild_sweeps,
                 prep_s=0.0, build_s=0.0, rounds_s=0.0)
    return types.SimpleNamespace(result=types.SimpleNamespace(
        seeds=ans.seeds, est_gains=ans.gains, scores=ans.scores, rebuilds=ans.rebuilds,
        propagate_iters=ans.build_sweeps, stats=stats))


def _unchanged(m, *args, **kwargs):
    return m.clone(), torch.zeros(1, dtype=torch.int32)


def _no_merge(acc, *args, **kwargs):
    return torch.zeros(1, dtype=torch.int32)


def _half_registers(real):
    def stats(m):
        half = m[:, : m.shape[1] // 2].contiguous()
        return real(half) * 2.0
    return stats


def _patch(monkeypatch, fault: str):
    from repro_torch import runtime
    from repro_torch.core import select
    from repro_torch.kernels import ops
    from repro_torch.partition import serial

    if fault == "control":
        monkeypatch.setattr(runtime, "run", _control_run)
    elif fault == "unchanged_propagate":
        monkeypatch.setattr(ops, "propagate_sweep", _unchanged)
    elif fault == "unchanged_cascade":
        monkeypatch.setattr(ops, "cascade_sweep", _unchanged)
    elif fault == "unchanged_bucket_cascade":
        monkeypatch.setattr(ops, "bucket_cascade", _no_merge)
    elif fault == "half_batch":
        monkeypatch.setattr(ops, "cardinality_stats", _half_registers(ops.cardinality_stats))
    elif fault == "no_exchange":
        monkeypatch.setattr(serial._RingState, "sweep_propagate", lambda self: self._ring(
            ops.bucket_propagate, self.p_rows, self.p_width, (0,)))
        monkeypatch.setattr(serial._RingState, "sweep_cascade", lambda self: self._ring(
            ops.bucket_cascade, self.c_rows, self.c_width, (0,)))
    elif fault == "altered_seed":
        calls = []
        real = select.finish_select

        def altered(sums, *args, **kwargs):
            s, gain = real(sums, *args, **kwargs)
            calls.append(1)
            return (s + 1 if len(calls) == 3 else s), gain
        monkeypatch.setattr(select, "finish_select", altered)
    elif fault == "altered_ring_seed":
        calls = []
        real = serial._RingState.select

        def altered_ring(self, *args):
            s, gain = real(self, *args)
            calls.append(1)
            return (s + 1 if len(calls) == 3 else s), gain
        monkeypatch.setattr(serial._RingState, "select", altered_ring)
    else:
        raise ValueError(fault)


CASES = ([(cell, f) for cell in SINGLE for f in ("control", "unchanged_propagate",
                                                 "unchanged_cascade", "half_batch",
                                                 "altered_seed")]
         + [(GRID, f) for f in ("control", "unchanged_bucket_cascade", "half_batch",
                                "no_exchange", "altered_ring_seed")])


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    bench, data = tiny_cell(tmp_path, cell, scale=9, registers=64, k=6)
    _patch(monkeypatch, fault)
    rc, lines = run_tiny(bench, data)
    out = result(lines)
    assert rc == 0 and out["correct"] is False and out["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in out["check"].values())


@pytest.mark.parametrize("cell", SINGLE + [GRID])
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3, 77])
def test_the_control_fails_on_every_seed(tmp_path, monkeypatch, cell, seed):
    bench, data = tiny_cell(tmp_path, cell, scale=8, registers=32, k=6)
    _patch(monkeypatch, "control")
    rc, lines = run_tiny(bench, data, seed=seed)
    assert rc == 0 and result(lines)["correct"] is False
