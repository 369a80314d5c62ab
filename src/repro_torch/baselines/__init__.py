"""The independent referee of the port's seeds: a Monte-Carlo oracle and the
RIS/IMM baseline, host numpy, as in the reference package."""
from repro_torch.baselines.mc_oracle import (exact_greedy, influence_score,
                                             make_live_sampler, sample_live_mask)
from repro_torch.baselines.ris import imm_num_rr_sets, ris_find_seeds

__all__ = ["influence_score", "exact_greedy", "ris_find_seeds", "imm_num_rr_sets",
           "make_live_sampler", "sample_live_mask"]
