"""The port's referees (``repro_torch.baselines``: the Monte-Carlo oracle
and the RIS/IMM baseline) against the reference's, on the CPU: the same
graph, seeds, model and RNG seed give the same scores and seeds exactly;
the launcher's ``--validate`` and ``--ris`` return the reference launcher's
numbers; and the zoo's Monte-Carlo hooks draw what the reference's draw."""
import numpy as np
import pytest

from repro.baselines import mc_oracle as R_mc
from repro.baselines import ris as R_ris
from repro.diffusion import resolve as r_resolve
from repro.graphs import rmat_graph as ref_rmat
from repro.graphs.structs import Graph as RGraph
from repro_torch.baselines import mc_oracle as T_mc
from repro_torch.baselines import ris as T_ris
from repro_torch.diffusion import resolve as t_resolve
from repro_torch.graphs import rmat_graph as port_rmat
from repro_torch.graphs.structs import Graph as TGraph

MODELS = ["wc", "ic:0.1", "lt", "dic:1.0"]


def _graphs(scale=8, edge_factor=6, seed=5, setting="w1"):
    return (ref_rmat(scale, edge_factor=edge_factor, seed=seed, setting=setting),
            port_rmat(scale, edge_factor=edge_factor, seed=seed, setting=setting))


def _tiny():
    rng = np.random.default_rng(11)
    src, dst = rng.integers(0, 14, 40), rng.integers(0, 14, 40)
    w = rng.uniform(0.1, 0.6, 40).astype(np.float32)
    return (RGraph.from_edges(14, src, dst, w, edge_block=8),
            TGraph.from_edges(14, src, dst, w, edge_block=8))


@pytest.mark.parametrize("model", MODELS)
def test_influence_score_matches_reference(model):
    rg, tg = _graphs()
    seeds = np.array([3, 17, 101, 250], dtype=np.int32)
    want = R_mc.influence_score(rg, seeds, num_sims=40, rng_seed=9, model=model)
    got = T_mc.influence_score(tg, seeds, num_sims=40, rng_seed=9, model=model)
    assert got == want and got >= len(seeds)


@pytest.mark.parametrize("model", MODELS)
def test_live_edge_hooks_match_reference(model):
    rg, tg = _graphs(7)
    rm, tm = r_resolve(model), t_resolve(model)
    assert tm.context_free_edges == rm.context_free_edges == (model != "lt")
    want = rm.mc_sampler(rg)(np.random.default_rng(4))
    got = tm.mc_sampler(tg)(np.random.default_rng(4))
    assert got.dtype == bool and np.array_equal(got, want)
    assert not got[tg.m_real:].any(), "a padding edge came out live"
    if model != "lt":
        np.testing.assert_array_equal(tm.live_edge_probability(tg),
                                      rm.live_edge_probability(rg))


@pytest.mark.parametrize("model", ["wc", "lt"])
def test_exact_greedy_matches_reference(model):
    rg, tg = _tiny()
    want_s, want_v = R_mc.exact_greedy(rg, 3, num_sims=30, rng_seed=2, model=model)
    got_s, got_v = T_mc.exact_greedy(tg, 3, num_sims=30, rng_seed=2, model=model)
    np.testing.assert_array_equal(got_s, want_s)
    assert got_s.dtype == np.int32 and got_v == want_v


def test_ris_matches_reference():
    rg, tg = _graphs()
    want_s, want_v = R_ris.ris_find_seeds(rg, 4, num_rr_sets=600, rng_seed=3)
    got_s, got_v = T_ris.ris_find_seeds(tg, 4, num_rr_sets=600, rng_seed=3)
    np.testing.assert_array_equal(got_s, want_s)
    assert got_s.dtype == np.int32 and got_v == want_v


@pytest.mark.parametrize("n,k,eps", [(512, 5, 0.5), (1 << 20, 50, 0.5), (2000, 10, 0.1),
                                     (100, 1, 2.0)])
def test_imm_num_rr_sets_matches_reference(n, k, eps):
    assert T_ris.imm_num_rr_sets(n, k, eps) == R_ris.imm_num_rr_sets(n, k, eps) >= 256


def test_ris_default_count_matches_reference():
    rg, tg = _tiny()
    want = R_ris.ris_find_seeds(rg, 2, epsilon=1.0, rng_seed=8, max_rr_sets=300)
    got = T_ris.ris_find_seeds(tg, 2, epsilon=1.0, rng_seed=8, max_rr_sets=300)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_launcher_validate_and_ris_match_reference():
    from repro.launch import im as R_im
    from repro_torch.launch import im as T_im

    argv = ["--graph", "rmat:9", "--registers", "64", "--k", "5", "--validate", "--ris"]
    want = R_im.run(argv)
    got = T_im.run(argv + ["--device", "cpu"])
    assert got["seeds"] == want["seeds"]
    assert got["oracle_score"] == want["oracle_score"]
    assert got["ris_oracle"] == want["ris_oracle"]
    assert {"oracle_score", "ris_time_s", "ris_oracle"} <= set(got)
