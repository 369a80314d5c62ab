"""The comparison that decides ``correct`` fails the four-card cell's
faults, in a whole run of a world of 4 gloo ranks at CPU size with the
timed path broken on every rank (the look for a card skipped): the control
(the reference in bfloat16 in the program's place), a cascade merge that
leaves its state unchanged, half of the registers left out of the
selection's statistics, the exchange between the ranks left out (every
ring shift hands back the rank's own block), one round's seed altered."""
import pytest

from imbench.tests._tiny import result
from imbench.tests.test_imbench_world import world_run

FAULTS = ["control", "unchanged_bucket_cascade", "half_batch", "no_exchange",
          "altered_seed"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_world_is_not_correct(tmp_path, fault):
    rc, lines, err = world_run(tmp_path, hook=fault, seed=2 ** 31 + 29)
    assert rc == 0, err
    out = result(lines)
    assert out["correct"] is False and out["failed"] >= 1
    assert any(v["value"] > v["limit"] for v in out["check"].values())
