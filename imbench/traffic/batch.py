"""The ``batch`` traffic kind: seed-set jobs back to back, as a user of
``python -m repro_torch im`` runs them once the graph is loaded.

A mix file of this kind gives:

* ``k``: the seeds a job selects;
* ``spec``: the execution fields of the program's ``RunSpec`` (backend,
  shard grid, partition, ring knobs);
* ``check_jobs``: how many of the window's jobs the reference recomputes.

The reference sums the selection's statistics over the spec's ``mu_s``
simulation shards (1 where the spec names none), as the program's 2-D
schedule does (``reference/alg4.py``, ``row_statistics``).

Set-up runs one warm-up job of ``WARMUP_K`` seeds at the cell's shapes.
Every job runs the configuration's model and register count under a hash
seed of its own, drawn from the run's seed and the job's index (the warm-up
job is index -1), so no two jobs of a run share their samples and no result
can be reused from one job to the next. Every seed gives every job the same
sizes.
"""
from __future__ import annotations

import numpy as np

#: the seeds of the one warm-up job of set-up
WARMUP_K = 2


class Batch:
    def __init__(self, traffic: dict, config: dict, seed: int):
        self.k = int(traffic["k"])
        self.check_jobs = int(traffic["check_jobs"])
        self.fields = dict(traffic["spec"])
        self.model = config["model"]
        self.num_registers = int(config["num_registers"])
        self.seed = int(seed)
        #: the simulation shards whose float32 sums the selection adds
        self.sim_shards = int(self.fields.get("mu_s", 1))

    def hash_seed(self, job: int) -> int:
        """Job ``job``'s hash seed, below 2^31."""
        state = np.random.SeedSequence([self.seed, job + 1]).generate_state(1)
        return int(state[0]) >> 1

    def spec_fields(self, job: int) -> dict:
        """The ``RunSpec`` fields of job ``job``."""
        return dict(self.fields, num_registers=self.num_registers, model=self.model,
                    seed=self.hash_seed(job))


def plan(traffic: dict, config: dict, seed: int) -> Batch:
    return Batch(traffic, config, seed)


def check(batch: Batch, done, edges, spec: dict, jobs, device):
    """Each number of the cell's check ``spec`` for each job of ``jobs``
    (indices into ``done``, the window's ``check.Outputs``), against the
    plain reference run on ``edges`` (``(n, src, dst, weight)``, the arrays
    the program's graph was made from)."""
    from imbench.harness import check as _check
    from imbench.reference import alg4

    n, src, dst, weight = edges
    per_job = []
    for job in jobs:
        ref = alg4.find_seeds(n, src, dst, weight, model=batch.model,
                              num_registers=batch.num_registers, k=batch.k,
                              seed=batch.hash_seed(job), device=device,
                              sim_shards=batch.sim_shards)
        per_job.append(_check.readings(done[job], ref, spec))
    return per_job
