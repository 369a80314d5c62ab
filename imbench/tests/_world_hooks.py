"""What a test asks each rank of a world to do before its run: each
function takes the rank and patches the program in that rank's process, as
the rank starts (``test_imbench_world.py::world_run``)."""
import os
import signal
import sys
import time
import types

import pytest

#: the rank that the hooks slow down, or make fail
ODD_RANK = 2
#: seconds the slow rank sleeps after each of its jobs
DELAY_S = 0.3
#: a top-level name that the benchmark forbids in a process of its run
FORBIDDEN = "flax"


def _on_job(rank, before=None, after=None):
    """Run ``before(call)`` and ``after(call)`` in ``rank`` around each job
    (call 1 is set-up's warm-up job)."""
    from repro_torch import runtime

    real, calls = runtime.run, []

    def run(*args, **kwargs):
        calls.append(1)
        if before:
            before(len(calls))
        out = real(*args, **kwargs)
        if after:
            after(len(calls))
        return out
    if rank == ODD_RANK:
        pytest.MonkeyPatch().setattr(runtime, "run", run)


def slow(rank):
    """The odd rank comes back from each job ``DELAY_S`` late, so that its
    own clock would read more of the window than rank 0's."""
    _on_job(rank, after=lambda call: time.sleep(DELAY_S))


def _raise(call):
    if call == 2:
        raise RuntimeError("a fault planted in the window's first job")


def raises(rank):
    _on_job(rank, before=_raise)


def _kill(call):
    if call == 2:
        os.kill(os.getpid(), signal.SIGKILL)


def killed(rank):
    _on_job(rank, before=_kill)


def _load_forbidden(call):
    if call == 2:
        sys.modules.setdefault(FORBIDDEN, types.ModuleType(FORBIDDEN))


def loads_forbidden(rank):
    """The odd rank loads a stand-in for a forbidden module in the window's
    first job."""
    _on_job(rank, after=_load_forbidden)


def _fault(name):
    def hook(rank):
        from imbench.tests import test_imbench_faults

        test_imbench_faults._patch(pytest.MonkeyPatch(), name)
    return hook


control = _fault("control")
unchanged_bucket_cascade = _fault("unchanged_bucket_cascade")
half_batch = _fault("half_batch")


def no_exchange(rank):
    """Every ring shift hands back the rank's own block: no block crosses
    between ranks."""
    from repro_torch.launch import mesh

    pytest.MonkeyPatch().setattr(mesh.Exchange, "ring_shift",
                                 lambda self, block, out, **kwargs: block)


def altered_seed(rank):
    """The third round's seed, as the grid's argmax hands it back, plus 1."""
    from repro_torch.core import distributed

    real, calls = distributed._RankState.select, []

    def select(self, *args):
        s, gain = real(self, *args)
        calls.append(1)
        return (s + 1 if len(calls) == 3 else s), gain
    pytest.MonkeyPatch().setattr(distributed._RankState, "select", select)
